"""The reference's target paths (counterpart of ``hcpdiff_tpu/compat.py``):
reference configs say ``_target_: hcpdiff.X.Y``, which
``config/instantiate.py:locate`` reads as ``hcpdiff_tpu_torch.compat.X.Y``;
this module exports the port's classes under the same names as the JAX
package's ``compat``. The names whose classes the port lacks yet
(ControlNet's dataset, the workflow actions) are stand-ins that raise
``NotImplementedError`` naming ROADMAP.md queue 1 item 7 when called or
read."""
from types import SimpleNamespace

from .data import buckets as _buckets
from .data import sources as _sources
from .data.captions import JsonCaptionLoader, TXTCaptionLoader, YamlCaptionLoader, auto_caption_loader
from .data.dataset import CropInfoPairDataset, CycleData, DataGroup, TextImagePairDataset
from .data.processor import ControlNetProcessor
from .data.transforms import TagDropout, TagErase, TagShuffle, TemplateFill
from .diffusion.losses import EDMLoss, KDiffMinSNRLoss, MinSNRLoss, MSELoss, SoftMinSNRLoss
from .diffusion.schedules import NoiseSchedule, pyramid_noise
from .loggers import CLILogger, LoggerGroup, TBLogger, WanDBLogger


def _refusal(name: str) -> NotImplementedError:
    return NotImplementedError(f'{name} is not ported to the PyTorch package yet (ROADMAP.md '
                               'queue 1 item 7)')


def _unported(name: str) -> type:
    """A class named ``name`` whose construction raises."""
    def __init__(self, *args, **kwargs):
        raise _refusal(name)
    return type(name, (), {'__init__': __init__, '__doc__': f'{name}: not ported yet.'})


class _UnportedModule:
    """A module of the reference whose every attribute raises."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        raise _refusal(f'{self._name}.{attr}')


TextImageCondPairDataset = _unported('TextImageCondPairDataset')

# the JAX package's workflow actions (``hcpdiff_tpu/workflow``)
WORKFLOW_NAMES = (
    'AttnMultTextEncodeAction', 'BasicAction', 'BuildModelLoaderAction', 'BuildPluginAction',
    'DecodeAction', 'DiffusionStepAction', 'EncodeAction', 'ExecAction', 'ImageResizeAction',
    'InputFeederAction', 'LatentResizeAction', 'LoadLoraAction', 'LoadModelsAction',
    'LoadPartAction', 'LoadPluginAction', 'LoopAction', 'MakeLatentAction', 'MakeTimestepsAction',
    'MemoryMixin', 'NoisePredAction', 'PrepareDiffusionAction', 'RemoveLoraAction',
    'RemovePluginAction', 'SampleAction', 'SaveImageAction', 'SeedAction', 'TextEncodeAction',
    'TextHookAction', 'VaeOptimizeAction', 'WorkflowRunner', 'X0PredAction',
    'resolve_from_memory')
globals().update({_n: _unported(_n) for _n in WORKFLOW_NAMES})
actions = _UnportedModule('workflow.actions')
base = _UnportedModule('workflow.base')


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
