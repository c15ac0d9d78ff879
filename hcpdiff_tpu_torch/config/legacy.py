"""Legacy config-schema converters (reference
hcpdiff/deprecated/cfg_converter.py:13-115): rewrite old-format keys to the
current schema at load time so old project yamls keep working. A copy of
``hcpdiff_tpu/config/legacy.py`` whose default targets name the port.
"""
from __future__ import annotations

from .node import Cfg, containerize


class DatasetCFGConverter:
    """Reference DatasetCFGConverter parity (cfg_converter.py:13-26):
    default source class is the att-map variant; 'tag_transforms' renamed."""

    def convert(self, cfg: Cfg) -> Cfg:
        for dataset in (cfg.get('data') or {}).values():
            if not isinstance(dataset, dict):
                continue
            for source in (dataset.get('source') or {}).values():
                if '_target_' not in source:
                    source['_target_'] = \
                        'hcpdiff_tpu_torch.data.sources.Text2ImageAttMapSource'
                if 'tag_transforms' in source:
                    source['text_transforms'] = source.pop('tag_transforms')
        return cfg


class TrainCFGConverter:
    def __init__(self):
        self.dataset_converter = DatasetCFGConverter()

    def convert(self, cfg: Cfg) -> Cfg:
        model = cfg.get('model') or Cfg()
        # old per-model ema flags -> unified ema block
        # (reference cfg_converter.py:33-44)
        if 'ema_unet' in model and 'ema' not in model:
            ema = model.get('ema_unet', 0)
            model['ema'] = (None if not ema else containerize({
                '_target_': 'hcpdiff_tpu_torch.trainer.ema.ModelEMA',
                '_partial_': True,
                'decay_max': ema, 'power': 0.85}))
        for key in ('tokenizer', 'noise_scheduler', 'unet', 'text_encoder', 'vae'):
            model.setdefault(key, None)
        cfg['model'] = model

        train = cfg.get('train') or Cfg()
        crit = ((train.get('loss') or {}).get('criterion') or {})
        if crit.get('_target_') in ('hcpdiff.loss.MSELoss', 'torch.nn.MSELoss'):
            crit['_target_'] = 'hcpdiff_tpu_torch.diffusion.losses.MSELoss'
        cfg.setdefault('previewer', None)
        return self.dataset_converter.convert(cfg)


class InferCFGConverter:
    def convert(self, cfg: Cfg) -> Cfg:
        if 'amp' not in cfg:
            if cfg.get('dtype') == 'amp':
                cfg['dtype'] = 'bf16'   # amp == autocast; bf16 on TPU
            cfg['amp'] = False
        cfg.setdefault('encoder_attention_mask', False)
        # old 'new_components' scheduler override block is accepted as-is
        return cfg
