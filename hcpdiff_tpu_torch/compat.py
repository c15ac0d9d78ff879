"""The reference's target paths (counterpart of ``hcpdiff_tpu/compat.py``):
reference configs say ``_target_: hcpdiff.X.Y``, which
``config/instantiate.py:locate`` reads as ``hcpdiff_tpu_torch.compat.X.Y``;
this module exports the port's classes under the same names as the JAX
package's ``compat``, the workflow actions among them."""
from types import SimpleNamespace

from .data import buckets as _buckets
from .data import sources as _sources
from .data.captions import JsonCaptionLoader, TXTCaptionLoader, YamlCaptionLoader, auto_caption_loader
from .data.dataset import (CropInfoPairDataset, CycleData, DataGroup, TextImageCondPairDataset,
                           TextImagePairDataset)
from .data.processor import ControlNetProcessor
from .data.transforms import TagDropout, TagErase, TagShuffle, TemplateFill
from .diffusion.losses import EDMLoss, KDiffMinSNRLoss, MinSNRLoss, MSELoss, SoftMinSNRLoss
from .diffusion.schedules import NoiseSchedule, pyramid_noise
from .loggers import CLILogger, LoggerGroup, TBLogger, WanDBLogger

# the workflow actions under the reference's names
from .workflow import *  # noqa: F401,F403


# reference module paths like hcpdiff.data.bucket.RatioBucket.from_files
class data:  # noqa: N801
    TextImagePairDataset = TextImagePairDataset
    TextImageCondPairDataset = TextImageCondPairDataset
    CropInfoPairDataset = CropInfoPairDataset
    DataGroup = DataGroup
    bucket = _buckets
    source = _sources
    caption_loader = SimpleNamespace(JsonCaptionLoader=JsonCaptionLoader,
                                     YamlCaptionLoader=YamlCaptionLoader,
                                     TXTCaptionLoader=TXTCaptionLoader,
                                     auto_caption_loader=auto_caption_loader)
    data_processor = SimpleNamespace(ControlNetProcessor=ControlNetProcessor)


class utils:  # noqa: N801
    caption_tools = SimpleNamespace(TagShuffle=TagShuffle, TagDropout=TagDropout,
                                    TagErase=TagErase, TemplateFill=TemplateFill)


class loggers:  # noqa: N801
    CLILogger = CLILogger
    TBLogger = TBLogger
    WanDBLogger = WanDBLogger


class loss:  # noqa: N801
    min_snr_loss = SimpleNamespace(MinSNRLoss=MinSNRLoss, SoftMinSNRLoss=SoftMinSNRLoss,
                                   KDiffMinSNRLoss=KDiffMinSNRLoss, EDMLoss=EDMLoss)
