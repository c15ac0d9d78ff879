"""The workflow engine (counterpart of ``hcpdiff_tpu/workflow``): ``base``
(the runner, loops, programs) and ``actions`` (models, text, diffusion,
VAE and resize steps), run by ``python -m hcpdiff_tpu_torch.infer_workflow``."""
from .base import BasicAction, ExecAction, LoopAction, MemoryMixin, WorkflowRunner, resolve_from_memory
from .actions import (AttnMultTextEncodeAction, BuildModelLoaderAction, BuildPluginAction,
                      DecodeAction, DiffusionStepAction, EncodeAction, ImageResizeAction,
                      InputFeederAction, LatentResizeAction, LoadLoraAction, LoadModelsAction,
                      LoadPartAction, LoadPluginAction, MakeLatentAction, MakeTimestepsAction,
                      NoisePredAction, PrepareDiffusionAction, RemoveLoraAction,
                      RemovePluginAction, SampleAction, SaveImageAction, SeedAction,
                      TextEncodeAction, TextHookAction, VaeOptimizeAction, X0PredAction)

__all__ = [n for n in dir() if not n.startswith('_')]
