"""Loggers (counterpart of ``hcpdiff_tpu/loggers/base.py``).

- ``CLILogger`` writes to stdout and ``train.log`` in the experiment
  directory, and images as ``imgs/<step>-<name>.png``;
- ``TBLogger`` writes TensorBoard event files under ``<exp_dir>/tb``
  through ``utils/tb_events.py`` (the port does not need the
  ``tensorboard`` package): scalars, and HWC images as PNG;
- ``WebUILogger`` prints ``[hcp-progress] step=<step> k=v ...`` lines for
  an external UI;
- ``WanDBLogger`` logs to Weights & Biases where ``wandb`` imports; where
  it does not, it switches itself off as the JAX logger does, and the
  group prints one warning line that names the missing package;
- ``LoggerGroup`` fans out to several and logs scalars every ``log_step``
  steps: the gcd of its enabled loggers'.
"""
from __future__ import annotations

import logging
import math
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.images import write_png
from ..utils.tb_events import EventFileWriter


def _uint8(image) -> np.ndarray:
    """A float image in [0, 1] as uint8, truncated as the JAX package's
    CLI logger and ``SummaryWriter.add_image`` convert it; uint8 stays as
    it is."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr.astype(np.float32), 0, 1) * 255).astype(np.uint8)
    return arr


class BaseLogger:
    def __init__(self, exp_dir: Optional[str] = None, log_step: int = 10,
                 image_log_step: int = 200, **kw):
        self.exp_dir = exp_dir
        self.log_step = int(log_step)
        self.image_log_step = int(image_log_step)
        self.enabled = True
        self.warning: Optional[str] = None     # printed once by the group

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def info(self, text: str):
        raise NotImplementedError

    def log(self, datas: Dict[str, Any], step: int = 0):
        raise NotImplementedError

    def log_image(self, images: Dict[str, Any], step: int = 0):
        pass

    def close(self):
        pass


class CLILogger(BaseLogger):
    """stdout + file logger (stdlib ``logging``)."""

    def __init__(self, exp_dir: Optional[str] = None, out_path: str = 'train.log',
                 log_step: int = 10, **kw):
        super().__init__(exp_dir, log_step, **kw)
        self.logger = logging.getLogger(f'hcpdiff_tpu_torch.{id(self)}')
        self.logger.setLevel(logging.INFO)
        self.logger.handlers.clear()
        # not into the root logger: a configured root handler would print twice
        self.logger.propagate = False
        fmt = logging.Formatter('%(asctime)s | %(message)s', '%H:%M:%S')
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        self.logger.addHandler(h)
        if exp_dir and out_path:
            fh = logging.FileHandler(os.path.join(exp_dir, out_path))
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def info(self, text: str):
        if self.enabled:
            self.logger.info(text)

    def log(self, datas: Dict[str, Any], step: int = 0):
        if self.enabled:
            kv = ', '.join(f'{k}={v:.5g}' if isinstance(v, float) else f'{k}={v}'
                           for k, v in datas.items())
            self.logger.info(f'[{step}] {kv}')

    def log_image(self, images: Dict[str, Any], step: int = 0):
        if not (self.enabled and self.exp_dir):
            return
        d = os.path.join(self.exp_dir, 'imgs')
        os.makedirs(d, exist_ok=True)
        for name, img in images.items():
            write_png(os.path.join(d, f'{step}-{name}.png'), _uint8(img))

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


class TBLogger(BaseLogger):
    """TensorBoard: the scalars of each ``log`` call (int and float
    values) and each ``log_image`` image, as ``SummaryWriter.add_scalar``
    and ``add_image(..., dataformats='HWC')`` write them."""

    def __init__(self, exp_dir: Optional[str] = None, **kw):
        super().__init__(exp_dir, **kw)
        self.writer = EventFileWriter(os.path.join(exp_dir or '.', 'tb'))

    def info(self, text: str):
        pass

    def log(self, datas: Dict[str, Any], step: int = 0):
        if self.enabled:
            for k, v in datas.items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(k, v, step)

    def log_image(self, images: Dict[str, Any], step: int = 0):
        if self.enabled:
            for k, v in images.items():
                self.writer.add_image(k, _uint8(v), step)

    def close(self):
        self.writer.close()


class WanDBLogger(BaseLogger):
    def __init__(self, exp_dir: Optional[str] = None, project: str = 'hcpdiff-tpu', **kw):
        super().__init__(exp_dir, **kw)
        try:
            import wandb
        except ImportError:
            self.wandb = None
            self.enabled = False
            self.warning = ('WanDBLogger: the wandb package is not installed; Weights & Biases '
                            'logging is off')
        else:
            self.wandb = wandb
            wandb.init(project=project, dir=exp_dir)

    def info(self, text: str):
        pass

    def log(self, datas, step=0):
        if self.enabled and self.wandb:
            self.wandb.log(datas, step=step)


class WebUILogger(CLILogger):
    """Machine-readable progress lines for an external UI."""

    def log(self, datas, step=0):
        if self.enabled:
            print(f'[hcp-progress] step={step} ' + ' '.join(f'{k}={v}' for k, v in datas.items()),
                  flush=True)


class LoggerGroup:
    def __init__(self, loggers: List[BaseLogger]):
        self.loggers = list(loggers)

    def add_logger(self, logger: BaseLogger):
        self.loggers.append(logger)

    def info(self, text: str):
        for l in self.loggers:
            l.info(text)

    def log(self, datas: Dict[str, Any], step: int = 0):
        for l in self.loggers:
            l.log(datas, step)

    def log_image(self, images: Dict[str, Any], step: int = 0):
        for l in self.loggers:
            l.log_image(images, step)

    def close(self):
        for l in self.loggers:
            l.close()

    @property
    def log_step(self) -> int:
        steps = [l.log_step for l in self.loggers if l.enabled]
        return math.gcd(*steps) if steps else 10


_BACKENDS = {'clilogger': CLILogger, 'tblogger': TBLogger, 'tensorboardlogger': TBLogger,
             'wandblogger': WanDBLogger, 'webuilogger': WebUILogger}


def build_loggers(cfg_list, exp_dir: Optional[str] = None) -> LoggerGroup:
    """From the config's ``logger:`` list of {_target_: ..., ...}; an
    unknown target raises. The warnings of loggers that switched
    themselves off go out through the group."""
    out: List[BaseLogger] = []
    for item in (cfg_list or []):
        spec = dict(item)
        tgt = str(spec.pop('_target_', 'CLILogger'))
        cls = _BACKENDS.get(tgt.split('.')[-1].lower())
        if cls is None:
            raise ValueError(f'logger: unknown _target_ {tgt!r}; known: {sorted(_BACKENDS)}')
        out.append(cls(exp_dir=exp_dir, **{k: v for k, v in spec.items()
                                          if k in ('out_path', 'log_step', 'image_log_step',
                                                   'project')}))
    if not out:
        out = [CLILogger(exp_dir=exp_dir)]
    group = LoggerGroup(out)
    for l in out:
        if l.warning:
            group.info(l.warning)
    return group
