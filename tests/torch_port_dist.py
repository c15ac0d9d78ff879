"""Ranks of the port's multi-process tests: ``launch`` starts a world of
CPU processes on the ``gloo`` backend (``torchrun``'s environment, one
process a rank), each running one scenario of this module as
``python -m tests.torch_port_dist SCENARIO SPEC.json``; each rank saves
what it saw with ``torch.save`` and the test reads it back. Every launch
has its own timeout, so a rank stuck in a collective fails its test.

The ranks import only torch, numpy and the port (never JAX): whatever the
JAX side contributes (weights, draws) comes in as pickled numpy.
"""
import builtins
import json
import os
import pathlib
import pickle
import signal
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
LAUNCH_TIMEOUT = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(scenario: str, n: int, out: pathlib.Path, timeout: float = LAUNCH_TIMEOUT, **spec):
    """Run ``scenario`` on ``n`` ranks; returns each rank's saved result."""
    spec_path = out / f'{scenario}.json'
    spec_path.write_text(json.dumps({**spec, 'out': str(out)}))
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port), OMP_NUM_THREADS='1',
                   PYTHONPATH=str(ROOT), WANDB_MODE='disabled')
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'tests.torch_port_dist', scenario, str(spec_path)],
            cwd=ROOT, env=env, stdout=open(out / f'{scenario}_rank{r}.log', 'w'),
            stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f'{scenario}: a rank did not finish in {timeout} s\n'
                             + _logs(scenario, n, out))
    codes = [p.returncode for p in procs]
    assert codes == [0] * n, f'{scenario}: exit codes {codes}\n' + _logs(scenario, n, out)
    return [torch.load(out / f'{scenario}_rank{r}.pt', weights_only=False) for r in range(n)]


def _logs(scenario, n, out):
    return '\n'.join(f'--- rank {r}\n' + (out / f'{scenario}_rank{r}.log').read_text()[-3000:]
                     for r in range(n))


# ------------------------------------------------------------ configs ----
def write_images(root: pathlib.Path, n: int = 4, seed: int = 3):
    from hcpdiff_tpu_torch.utils.images import write_png
    imgs = root / 'imgs'
    imgs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_png(str(imgs / f'img_{i}.png'), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    with open(imgs / 'captions.json', 'w') as f:
        json.dump({f'img_{i}': f'a photo of cat {i}' for i in range(n)}, f)
    return imgs


OPT_LR = {'adamw': 1e-3, 'lion': 1e-4, 'adafactor': 1e-3, 'prodigy': 1.0}


def train_cfg(imgs, exp_dir, optimizer='adamw', zero=0, fsdp=1, steps=2, batch=2, **train):
    """UNet + CLIP LoRA and the time-embedding MLP fine-tuned (a 128 x 128
    weight: Adafactor factors it), EMA, clip 1.0, the latent cache, fp32 on
    the CPU; ``batch`` is per rank (the global batch of 2 ranks is 4)."""
    lr = OPT_LR[optimizer]
    return {
        'exp_dir': str(exp_dir), 'device': 'cpu', 'mixed_precision': 'fp32', 'seed': 1,
        'fsdp': fsdp,
        'train': {'train_steps': steps, 'save_step': steps, 'zero': zero, 'max_grad_norm': 1.0,
                  'preemption': False, 'optimizer': {'_target_': f'optim.{optimizer}'},
                  'scheduler': {'name': 'constant', 'num_warmup_steps': 0}, **train},
        'model': {'pretrained_model_name_or_path': 'tiny', 'gradient_checkpointing': False,
                  'ema': {'decay_max': 0.9999}},
        'logger': [{'_target_': 'CLILogger', 'log_step': 1}],
        'lora_unet': [{'lr': lr, 'rank': 2, 'layers': ['re:.*\\.attn.?$', 're:.*\\.ff$']}],
        'lora_text_encoder': [{'lr': lr / 2, 'rank': 2, 'layers': ['re:.*self_attn$']}],
        'unet': [{'lr': lr, 'layers': ['re:.*time_embedding.*']}],
        'data': {'dataset1': {
            'batch_size': batch, 'cache_latents': True,
            'source': {'s1': {'img_root': str(imgs),
                              'caption_file': str(pathlib.Path(imgs) / 'captions.json')}},
            'bucket': {'_target_': 'FixedBucket', 'target_size': 32}}},
        'tokenizer_pt': {'emb_dir': None, 'train': None},
    }


def flat_pack(trainer):
    """The whole pack (gathered: a collective) as one fp32 vector."""
    from hcpdiff_tpu_torch.trainer.step import pack_leaves
    with trainer.whole():
        return torch.cat([t.detach().reshape(-1).float().clone()
                          for t in pack_leaves(trainer.state.pack)])


def state_bytes(trainer):
    from hcpdiff_tpu_torch.trainer.step import pack_leaves
    st = trainer.state
    per_leaf = {}
    for key in ('optimizer', 'optimizer_pt'):
        opt = getattr(st, key)
        if opt is None:
            continue
        for p, s in opt.state.items():
            per_leaf[id(p)] = sum(v.numel() * v.element_size() for v in s.values()
                                  if torch.is_tensor(v))
    return {'opt': sum(per_leaf.values()), 'opt_leaves': list(per_leaf.values()),
            'pack': sum(t.numel() * t.element_size() for t in pack_leaves(st.pack)),
            'pack_leaves': [int(np.prod(s)) * torch.empty(0, dtype=d).element_size()
                            for s, d in trainer.dp.shapes] if trainer.dp else None}


# ---------------------------------------------------------- scenarios ----
def scenario_helpers(spec):
    """The mesh helpers across the ranks."""
    from hcpdiff_tpu_torch.parallel import mesh as pm
    pm.init_distributed('cpu')
    mesh = pm.make_mesh()
    rank = pm.process_index()
    pm.barrier()
    return {'string': pm.broadcast_string(f'exps/from-rank-{rank}'),
            'gathered': pm.gather_to_host({'rank': rank, 't': torch.full((2,), float(rank))}),
            'slice': pm.local_slice(8, mesh), 'shape': mesh.shape, 'main': pm.is_main_process()}


def scenario_matrix(spec):
    """Every run of ``spec['runs']`` ((name, optimizer, zero, fsdp), ...) on
    these ranks: the gathered pack, the losses and the bytes held."""
    from hcpdiff_tpu_torch.config import containerize
    from hcpdiff_tpu_torch.trainer.trainer import Trainer
    out = {'helpers': scenario_helpers(spec)}
    for name, opt, zero, fsdp in spec['runs']:
        cfg = train_cfg(spec['imgs'], pathlib.Path(spec['out']) / name, opt, zero, fsdp)
        trainer = Trainer(containerize(cfg))
        before = state_bytes(trainer)
        trainer.train()
        out[name] = {'pack': flat_pack(trainer), 'history': trainer.history,
                     'bytes': state_bytes(trainer), 'bytes_before': before,
                     'frozen': (trainer.frozen_shards.held_bytes(),
                                trainer.frozen_shards.full_bytes())
                     if trainer.frozen_shards else None}
    return out


def _port_world(spec):
    """The port's tiny world on the JAX world's weights (pickled numpy)."""
    from hcpdiff_tpu_torch.ckpt.bridge import load_params
    from hcpdiff_tpu_torch.models import clip as tclip
    from hcpdiff_tpu_torch.models import factory as tfactory
    from hcpdiff_tpu_torch.models import unet as tunet
    from hcpdiff_tpu_torch.models import vae as tvae
    from hcpdiff_tpu_torch.utils.clip_tokenizer import CLIPTokenizer
    with open(spec['world'], 'rb') as f:
        w = pickle.load(f)
    te_cfg = tclip.CLIPTextConfig.tiny(**w['te_ids'])
    unet_cfg = tunet.UNetConfig.tiny(cross_attention_dim=te_cfg.hidden_size)
    vae_cfg = tvae.VAEConfig.tiny()
    return {'sdxl': False,
            'unet': tfactory._finish(load_params(tunet.UNet2DCondition(unet_cfg),
                                                 w['unet_params'])),
            'vae': tfactory._finish(load_params(tvae.AutoencoderKL(vae_cfg), w['vae_params'])),
            'te': tfactory._finish(load_params(tclip.CLIPTextModel(te_cfg), w['te_params'])),
            'tokenizer': CLIPTokenizer.tiny(words=w['words']),
            'aliases': {'unet': tfactory.unet_alias_map(unet_cfg),
                        'te': tfactory.clip_alias_map(te_cfg),
                        'vae': tfactory.vae_alias_map(vae_cfg)}}


def scenario_jax_zero3(spec):
    """The zero-3 full fine-tune on the JAX world's weights, started from the
    JAX trainer's pack and fed its draws (the global batch's)."""
    from hcpdiff_tpu_torch.config import containerize
    from hcpdiff_tpu_torch.trainer.step import pack_leaves
    from hcpdiff_tpu_torch.trainer.trainer import Trainer
    with open(spec['draws'], 'rb') as f:
        fed = pickle.load(f)
    trainer = Trainer(containerize(spec['cfg']), world=_port_world(spec))
    with trainer.whole(), torch.no_grad():
        for key, tree in fed['pack0'].items():
            for name, src in tree.items():
                trainer.state.pack[key][name].copy_(torch.from_numpy(src))
    held = state_bytes(trainer)
    trainer.train(draws=lambda step, di, batch: [
        (torch.from_numpy(n), torch.from_numpy(t)) for n, t in fed['draws'][step]])
    return {'pack': flat_pack(trainer), 'history': trainer.history, 'held': held}


class _WriteLog:
    """Paths this process opens for writing or creates, while installed."""

    def __init__(self, root):
        self.root, self.paths = str(root), []

    def __enter__(self):
        self._open, self._makedirs, self._replace = builtins.open, os.makedirs, os.replace

        def opened(file, mode='r', *a, **kw):
            if isinstance(file, (str, os.PathLike)) and any(c in mode for c in 'wax+'):
                self._note(file)
            return self._open(file, mode, *a, **kw)

        def makedirs(name, *a, **kw):
            self._note(name)
            return self._makedirs(name, *a, **kw)

        def replace(src, dst, *a, **kw):
            self._note(dst)
            return self._replace(src, dst, *a, **kw)
        builtins.open, os.makedirs, os.replace = opened, makedirs, replace
        return self

    def _note(self, path):
        path = os.path.abspath(os.fspath(path))
        if path.startswith(self.root):
            self.paths.append(path)

    def __exit__(self, *exc):
        builtins.open, os.makedirs, os.replace = self._open, self._makedirs, self._replace
        return False


def _sdxl_args(spec, exp, *extra):
    src = 'data.dataset1.source.data_source1'
    imgs = spec['imgs']
    return ['--cfg', str(ROOT / 'cfgs' / 'train' / 'examples' / 'FT_sdxl_zero3.yaml'),
            'model.pretrained_model_name_or_path=tiny_sdxl', 'device=cpu',
            'mixed_precision=fp32', f'exp_dir={exp}', 'logger.0.log_step=1',
            f'{src}.img_root={imgs}', f'{src}.caption_file={imgs}/captions.json',
            'data.dataset1.bucket.target_area=1024', 'data.dataset1.bucket.step_size=16',
            'data.dataset1.batch_size=2', *extra]


def scenario_sdxl_zero3(spec):
    """FT_sdxl_zero3.yaml through main(): 2 steps saving at 2, then a
    resume (train.resume.auto) to step 3; what each rank wrote and holds."""
    from hcpdiff_tpu_torch.trainer.step import pack_leaves
    from hcpdiff_tpu_torch.trainer.trainer import main
    exp = pathlib.Path(spec['out']) / 'exp_sdxl'
    with _WriteLog(exp) as writes:
        first = main(_sdxl_args(spec, exp, 'train.train_steps=2', 'train.save_step=2'))
        first_pack = flat_pack(first)
        resumed = main(_sdxl_args(spec, exp, 'train.train_steps=3', 'train.save_step=2',
                                  'train.resume.auto=true'))
    held = [t.numel() for t in pack_leaves(resumed.state.pack)]
    return {'zero': resumed.zero, 'start_step': resumed.start_step, 'held': held,
            'shapes': [int(np.prod(s)) for s, _ in resumed.dp.shapes],
            'owned': [resumed.dp.owns(i) for i in range(len(held))],
            'history': (first.history, resumed.history), 'first_pack': first_pack,
            'pack': flat_pack(resumed), 'writes': writes.paths, 'exp': str(exp)}


def scenario_preempt(spec):
    """A LoRA run of 8 steps polled every 2; rank 1 signals itself once,
    during step 3."""
    from hcpdiff_tpu_torch.config import containerize
    from hcpdiff_tpu_torch.parallel import mesh as pm
    from hcpdiff_tpu_torch.trainer.trainer import Trainer
    cfg = train_cfg(spec['imgs'], pathlib.Path(spec['out']) / 'exp_preempt', steps=8,
                    preemption=True, preemption_poll_step=2)
    cfg['train']['save_step'] = 100
    trainer = Trainer(containerize(cfg))
    me = pm.process_index()

    def draws(step, di, batch):
        if me == 1 and step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return None
    stopped = trainer.train(draws=draws)
    return {'stopped': stopped, 'preempted': trainer.preempted,
            'states': trainer.states.steps()}


def scenario_tp(spec):
    """The tiny UNet (JAX weights) under each (tp, data) of spec['meshes'];
    the validation errors."""
    from hcpdiff_tpu_torch.ckpt.bridge import load_params
    from hcpdiff_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from hcpdiff_tpu_torch.parallel import mesh as pm
    from hcpdiff_tpu_torch.parallel.tp import make_tp_mesh, tp_unet_apply, tp_unet_config
    pm.init_distributed('cpu')
    with open(spec['inputs'], 'rb') as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        cfg = getattr(UNetConfig, case['cfg'])(**case['cfg_kw'])
        for tp, data in spec['meshes']:
            mesh = make_tp_mesh(tp=tp, data=data)
            unet = load_params(UNet2DCondition(tp_unet_config(cfg, tp)), case['params']).eval()
            fn = tp_unet_apply(unet, mesh)
            args = [torch.from_numpy(case[k]) for k in ('x', 't', 'ctx')]
            extras = {k: torch.from_numpy(v) for k, v in case.get('extras', {}).items()}
            with torch.no_grad():
                out[(name, tp, data)] = fn(*args, **extras)
    # txt2img through DiffusionPipeline, the tensor-parallel UNet in place of
    # the UNet: the denoise loop runs unchanged
    from hcpdiff_tpu_torch.infer.pipeline import DiffusionPipeline
    from hcpdiff_tpu_torch.models.factory import build_models
    from hcpdiff_tpu_torch.models.text_frontend import TextEncoderFrontend
    world = build_models('tiny', dtype=torch.float32, device='cpu', seed=0)
    frontend = TextEncoderFrontend(world['tokenizer'], world['te'])
    request = dict(width=32, height=32, num_steps=3, seed=3, batch_size=2)
    with torch.no_grad():
        out['txt2img'] = DiffusionPipeline(world['unet'], world['vae'], frontend).txt2img(
            'a photo of cat', **request)
        for tp, data in spec['meshes']:
            unet = UNet2DCondition(tp_unet_config(world['unet'].cfg, tp))
            unet.load_state_dict(world['unet'].state_dict())
            pipe = DiffusionPipeline(tp_unet_apply(unet, make_tp_mesh(tp=tp, data=data)),
                                     world['vae'], frontend)
            out[('txt2img', tp, data)] = pipe.txt2img('a photo of cat', **request)
    errors = {}
    cfg = UNetConfig.tiny(num_heads=(2, 2))
    mesh = make_tp_mesh(tp=1, data=2)
    fn = tp_unet_apply(UNet2DCondition(cfg), mesh)
    x = torch.zeros(3, 8, 8, 4)
    try:
        fn(x, torch.zeros(3), torch.zeros(3, 7, 32))
    except ValueError as e:
        errors['batch'] = str(e)
    mesh2 = make_tp_mesh(tp=2, data=1)
    for what, kw in (('qkv_bias', {'cfg': tp_unet_config(UNetConfig.tiny(num_heads=(2, 2),
                                                                         qkv_bias=True), 2)}),
                     ('fused', {'cfg': tp_unet_config(cfg, 2), 'fused_sublayers': True})):
        unet = UNet2DCondition(kw.pop('cfg'), **kw)
        try:
            with torch.no_grad():
                tp_unet_apply(unet, mesh2)(torch.zeros(2, 8, 8, 4), torch.zeros(2),
                                           torch.zeros(2, 7, 32))
        except NotImplementedError as e:
            errors[what] = str(e)
    return {'out': out, 'errors': errors}


SCENARIOS = {'matrix': scenario_matrix, 'jax_zero3': scenario_jax_zero3,
             'sdxl_zero3': scenario_sdxl_zero3, 'preempt': scenario_preempt, 'tp': scenario_tp}


def main(argv):
    scenario, spec_path = argv
    torch.set_num_threads(1)
    spec = json.loads(pathlib.Path(spec_path).read_text())
    result = SCENARIOS[scenario](spec)
    import torch.distributed as dist
    rank = dist.get_rank()
    torch.save(result, pathlib.Path(spec['out']) / f'{scenario}_rank{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1:])
