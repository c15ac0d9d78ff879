"""Loggers (counterpart of ``hcpdiff_tpu/loggers/base.py``).

``CLILogger`` writes to stdout and ``train.log`` in the experiment
directory; ``LoggerGroup`` fans out to several and logs scalars every
``log_step`` steps (the gcd of its loggers'). The TensorBoard and W&B
backends need packages the port does not depend on and raise, as the
image previewer (``previewer:``) does; both are ROADMAP.md queue 1 item 6.
"""
from __future__ import annotations

import logging
import math
import os
import sys
from typing import Any, Dict, List, Optional

ROADMAP = 'ROADMAP.md queue 1 item 6'


class BaseLogger:
    def __init__(self, exp_dir: Optional[str] = None, log_step: int = 10, **kw):
        self.exp_dir = exp_dir
        self.log_step = int(log_step)

    def info(self, text: str):
        raise NotImplementedError

    def log(self, datas: Dict[str, Any], step: int = 0):
        raise NotImplementedError


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
        self.logger.info(text)

    def log(self, datas: Dict[str, Any], step: int = 0):
        kv = ', '.join(f'{k}={v:.5g}' if isinstance(v, float) else f'{k}={v}'
                       for k, v in datas.items())
        self.logger.info(f'[{step}] {kv}')

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


class TBLogger(BaseLogger):
    def __init__(self, *a, **kw):
        raise NotImplementedError(f'TBLogger needs the tensorboard package, which the PyTorch '
                                  f'port does not depend on ({ROADMAP})')


class WanDBLogger(BaseLogger):
    def __init__(self, *a, **kw):
        raise NotImplementedError(f'WanDBLogger needs the wandb package, which the PyTorch '
                                  f'port does not depend on ({ROADMAP})')


class LoggerGroup:
    def __init__(self, loggers: List[BaseLogger]):
        self.loggers = list(loggers)

    def info(self, text: str):
        for l in self.loggers:
            l.info(text)

    def log(self, datas: Dict[str, Any], step: int = 0):
        for l in self.loggers:
            l.log(datas, step)

    def close(self):
        for l in self.loggers:
            if hasattr(l, 'close'):
                l.close()

    @property
    def log_step(self) -> int:
        return math.gcd(*(l.log_step for l in self.loggers))


_BACKENDS = {'clilogger': CLILogger, 'tblogger': TBLogger, 'tensorboardlogger': TBLogger,
             'wandblogger': WanDBLogger}


def build_loggers(cfg_list, exp_dir: Optional[str] = None) -> LoggerGroup:
    """From the config's ``logger:`` list of {_target_: ..., ...}; an
    unknown target raises."""
    out: List[BaseLogger] = []
    for item in (cfg_list or []):
        spec = dict(item)
        tgt = str(spec.pop('_target_', 'CLILogger'))
        cls = _BACKENDS.get(tgt.split('.')[-1].lower())
        if cls is None:
            raise ValueError(f'logger: unknown _target_ {tgt!r}; known: {sorted(_BACKENDS)}')
        out.append(cls(exp_dir=exp_dir, **{k: v for k, v in spec.items()
                                          if k in ('out_path', 'log_step')}))
    if not out:
        out = [CLILogger(exp_dir=exp_dir)]
    return LoggerGroup(out)
