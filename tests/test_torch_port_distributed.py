"""The port's multi-process trainer (``hcpdiff_tpu_torch/parallel/``) on
CPU ``gloo`` ranks, each world launched by ``tests/torch_port_dist.py``
with its own timeout:

- data parallelism: 2 ranks (``batch_size: 2`` a rank, as in the JAX
  trainer: each loads idx[r::2] of a global batch of 4) against one
  process stepping on the global batch as the ranks assemble it, 2 steps:
  the pack within 1e-6 relative L2;
- ZeRO 1, 2 and 3 against level 0 on the same ranks, and ``fsdp: 2``
  against one process (the same global batch), under AdamW, Lion,
  Adafactor and Prodigy: the pack within 1e-6 relative L2;
- the bytes a rank holds: at most 1/W of the optimizer state plus its
  largest leaf's (zero 1), of the pack (zero 3), and 1/N of the frozen
  base (fsdp);
- the zero-3 full fine-tune (``tests/test_zero.py:_ft_cfg``) on 2 ranks,
  fed the JAX trainer's draws, against the JAX trainer on 2 devices: the
  pack within 1e-5 relative L2 after one step (``batch_size: 2`` a
  device in both);
- ``FT_sdxl_zero3.yaml`` at tiny width on 2 ranks trains, saves and
  resumes, sharded again; only rank 0 writes, and a one-process resume of
  its state saves byte-equal files;
- a preemption signal on rank 1 alone stops both ranks at the same step;
- ``parallel/dryrun.py`` on 4 ranks as a 2 x 2 (data, fsdp) grid;
- the mesh helpers, and the ZeRO layout rules in one process.
"""
import filecmp
import os
import pathlib
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from hcpdiff_tpu.config import containerize as jcontainerize
from hcpdiff_tpu.trainer import trainer as jtrainer
from hcpdiff_tpu_torch.config import containerize
from hcpdiff_tpu_torch.data.dataset import TextImagePairDataset
from hcpdiff_tpu_torch.parallel import mesh as pm
from hcpdiff_tpu_torch.parallel.zero import owners, zero_level
from hcpdiff_tpu_torch.trainer.step import optimizer_groups, pack_leaves
from hcpdiff_tpu_torch.trainer.trainer import Trainer, main
from tests.test_torch_port_trainer import _jax_draws, _jax_pack_as_port, jax_world, port_world
from tests.torch_port_common import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_port_dist import launch, train_cfg, write_images

OPTS = ('adamw', 'lion', 'adafactor', 'prodigy')
W = 2


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope='module')
def matrix(tmp_path_factory):
    """One world of 2 ranks: every optimizer at zero 0-3 (data 2) and at
    fsdp 2 (data 1), 2 steps each."""
    out = tmp_path_factory.mktemp('dist_matrix')
    imgs = write_images(out)
    runs = [(f'{o}_z{z}', o, z, 1) for o in OPTS for z in (0, 1, 2, 3)]
    runs += [(f'{o}_fsdp2', o, 0, 2) for o in OPTS]
    return imgs, launch('matrix', W, out, runs=runs, imgs=str(imgs))


def _one_process(imgs, exp, optimizer='adamw', assembled=False, monkeypatch=None):
    """The same run in this process (no process group). ``assembled``: each
    batch in the order the ranks assemble it (rank r's idx[r::W] as block r)."""
    if assembled:
        rows = TextImagePairDataset._rows

        def assembled_rows(self, bi):
            idx, size = rows(self, bi)
            return [i for r in range(W) for i in list(idx)[r::W]], size
        monkeypatch.setattr(TextImagePairDataset, '_rows', assembled_rows)
    trainer = Trainer(containerize(train_cfg(imgs, exp, optimizer, batch=2 * W)))
    trainer.train()
    flat = torch.cat([t.detach().reshape(-1) for t in pack_leaves(trainer.state.pack)])
    return flat, trainer.history


def test_data_parallel_matches_one_process(matrix, tmp_path, monkeypatch):
    imgs, ranks = matrix
    flat, history = _one_process(imgs, tmp_path / 'one', assembled=True, monkeypatch=monkeypatch)
    got = ranks[0]['adamw_z0']
    assert rel(got['pack'], flat) <= 1e-6
    np.testing.assert_allclose(got['history'], history, rtol=1e-5)
    assert torch.equal(ranks[0]['adamw_z0']['pack'], ranks[1]['adamw_z0']['pack'])


@pytest.mark.parametrize('level', (1, 2, 3))
@pytest.mark.parametrize('opt', OPTS)
def test_zero_level_matches_level_0(matrix, opt, level):
    _, ranks = matrix
    ref = ranks[0][f'{opt}_z0']
    for r in range(W):
        got = ranks[r][f'{opt}_z{level}']
        assert rel(got['pack'], ref['pack']) <= 1e-6, (r, rel(got['pack'], ref['pack']))
        np.testing.assert_allclose(got['history'], ref['history'], rtol=1e-6)


@pytest.mark.parametrize('opt', OPTS)
def test_fsdp_matches_one_process(matrix, tmp_path, opt):
    imgs, ranks = matrix
    flat, _ = _one_process(imgs, tmp_path / 'one', opt)
    for r in range(W):
        assert rel(ranks[r][f'{opt}_fsdp2']['pack'], flat) <= 1e-6


def test_zero1_optimizer_state_bytes(matrix):
    """Each rank holds at most 1/W of the optimizer state's bytes plus its
    largest leaf's (level 0 holds all of it on every rank)."""
    _, ranks = matrix
    for opt in OPTS:
        whole = ranks[0][f'{opt}_z0']['bytes']['opt']
        largest = max(ranks[0][f'{opt}_z0']['bytes']['opt_leaves'])
        mine = [ranks[r][f'{opt}_z1']['bytes']['opt'] for r in range(W)]
        # Prodigy keeps its group's d and numerator (8 bytes) on each rank of the group
        assert whole <= sum(mine) <= whole + 64, (opt, mine, whole)
        for m in mine:
            assert 0 < m <= whole / W + largest, (opt, m, whole)


def test_zero3_pack_bytes(matrix):
    """Between steps each rank holds its own leaves of the pack: at most
    1/W of its bytes plus the largest leaf's, before the first step and
    after the last."""
    _, ranks = matrix
    whole = ranks[0]['adamw_z0']['bytes']['pack']
    leaves = ranks[0]['adamw_z3']['bytes']['pack_leaves']
    assert sum(leaves) == whole
    for key in ('bytes_before', 'bytes'):
        held = [ranks[r]['adamw_z3'][key]['pack'] for r in range(W)]
        assert sum(held) == whole
        assert all(0 < h <= whole / W + max(leaves) for h in held), held
    for level in (1, 2):
        assert ranks[1][f'adamw_z{level}']['bytes']['pack'] == whole


def test_fsdp_frozen_base_bytes(matrix):
    _, ranks = matrix
    for r in range(W):
        held, full = ranks[r]['adamw_fsdp2']['frozen']
        assert full > 0 and held <= full / W + 64 and held >= full / W


def test_mesh_helpers_across_ranks(matrix):
    _, ranks = matrix
    for r, res in enumerate(ranks):
        h = res['helpers']
        assert h['string'] == 'exps/from-rank-0'
        assert [g['rank'] for g in h['gathered']] == [0, 1]
        assert torch.equal(h['gathered'][1]['t'], torch.ones(2))
        assert h['slice'] == (4 * r, 4) and h['shape'] == {'data': 2, 'fsdp': 1}
        assert h['main'] == (r == 0)


# --------------------------------------------------- against JAX ----
def _ft_cfg(proj, name):
    """tests/test_zero.py:_ft_cfg at zero 3, with AdamW's eps at 1e-3 (as
    test_torch_port_trainer.py's parity cases: at the default 1e-8 a
    gradient element at fp32 noise level moves by a full lr, so two
    correct implementations differ by ~lr there)."""
    return {
        'exp_dir': str(proj / name), 'mixed_precision': 'fp32', 'seed': 1,
        'ckpt_type': 'safetensors',
        'train': {'train_steps': 1, 'save_step': 1, 'zero': 3, 'gradient_accumulation_steps': 1,
                  'max_grad_norm': 1.0, 'cfg_scale': '1.0', 'preemption': False,
                  'loss': {'criterion': {'_target_': 'mse'}},
                  'optimizer': {'_target_': 'optim.adamw', 'eps': 1e-3},
                  'scheduler': {'name': 'constant', 'num_warmup_steps': 0,
                                'num_training_steps': 1}},
        'model': {'pretrained_model_name_or_path': 'tiny', 'tokenizer_repeats': 1,
                  'gradient_checkpointing': False},
        'logger': [{'_target_': 'CLILogger', 'log_step': 1}],
        'unet': [{'lr': 1e-5, 'layers': ['re:.*']}],
        'data': {'dataset1': {
            'batch_size': 2, 'cache_latents': True,
            'source': {'s1': {'img_root': str(proj / 'imgs'),
                              'caption_file': str(proj / 'imgs' / 'captions.json')}},
            'bucket': {'_target_': 'FixedBucket', 'target_size': 32}}},
        'tokenizer_pt': {'emb_dir': None, 'train': None},
    }


def test_zero3_matches_jax_trainer(tmp_path, jax_world, monkeypatch):
    write_images(tmp_path)
    monkeypatch.setattr(jtrainer, 'build_models', lambda *a, **kw: dict(jax_world))
    mesh = jtrainer.make_mesh
    monkeypatch.setattr(jtrainer, 'make_mesh', lambda **kw: mesh(devices=jax.devices()[:W]))
    jt = jtrainer.Trainer(jcontainerize(_ft_cfg(tmp_path, 'jax')))
    assert jt.zero_level == 3 and jt.world_size == W
    keys, step_fn = [], jt._train_step

    def recorded(state, frozen, batch, rng):
        keys.append((rng, tuple(np.asarray(batch['latents']).shape)))
        return step_fn(state, frozen, batch, rng)
    jt._train_step = recorded
    world = port_world(jax_world)
    pack0 = _jax_pack_as_port(jt.state.pack, world)
    assert jt.train() == 1
    want = torch.cat([t.reshape(-1) for t in pack_leaves(_jax_pack_as_port(jt.state.pack,
                                                                           world))])
    fed = {'pack0': {k: {n: t.numpy() for n, t in tree.items()} for k, tree in pack0.items()},
           'draws': [[(n.numpy(), t.numpy()) for n, t in _jax_draws(key, shape, 1)]
                     for key, shape in keys]}
    with open(tmp_path / 'draws.pkl', 'wb') as f:
        pickle.dump(fed, f)
    te = jax_world['te_cfg']
    with open(tmp_path / 'world.pkl', 'wb') as f:
        pickle.dump({k: jax.tree_util.tree_map(np.asarray, jax_world[k])
                     for k in ('unet_params', 'vae_params', 'te_params')}
                    | {'te_ids': {'vocab_size': te.vocab_size, 'eos_token_id': te.eos_token_id,
                                  'bos_token_id': te.bos_token_id},
                       'words': ['cat', 'dog', 'photo', 'painting']}, f)
    cfg = dict(_ft_cfg(tmp_path, 'port'), device='cpu')
    ranks = launch('jax_zero3', W, tmp_path, cfg=cfg, world=str(tmp_path / 'world.pkl'),
                   draws=str(tmp_path / 'draws.pkl'))
    moved = rel(want, torch.cat([t.reshape(-1) for t in pack_leaves(pack0)]))
    for r in range(W):
        assert rel(ranks[r]['pack'], want) <= 1e-5, (rel(ranks[r]['pack'], want), moved)
        # the pack was sharded: each rank held about half of it
        assert ranks[r]['held']['pack'] < 0.75 * sum(ranks[r]['held']['pack_leaves'])


# ------------------------------------------------ FT_sdxl_zero3.yaml ----
@pytest.fixture(scope='module')
def sdxl(tmp_path_factory):
    out = tmp_path_factory.mktemp('dist_sdxl')
    imgs = write_images(out)
    return out, imgs, launch('sdxl_zero3', W, out, imgs=str(imgs))


def test_ft_sdxl_zero3_trains_saves_and_resumes_sharded(sdxl):
    out, _, ranks = sdxl
    for r, res in enumerate(ranks):
        first, resumed = res['history']
        assert res['zero'] == 3 and len(first) == 2 and len(resumed) == 1
        assert all(np.isfinite(first + resumed))
        assert res['start_step'] == 2
        # sharded again after the resume: the leaves of the other rank hold nothing
        assert [h == (s if o else 0) for h, s, o in zip(res['held'], res['shapes'],
                                                        res['owned'])] == [True] * len(res['held'])
        assert 0 < sum(o for o in res['owned']) < len(res['owned'])
    assert torch.equal(ranks[0]['pack'], ranks[1]['pack'])
    exp = pathlib.Path(ranks[0]['exp'])
    assert sorted(os.listdir(exp / 'ckpts')) == ['unet-2.safetensors', 'unet-3.safetensors']
    assert sorted(os.listdir(exp / 'state')) == ['state_2.pt', 'state_3.pt']


def test_only_rank_0_writes(sdxl):
    _, _, ranks = sdxl
    assert ranks[1]['writes'] == []
    assert any(p.endswith('state_3.pt') for p in ranks[0]['writes'])


def _same(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(_same(a[k], b[k])
                                                                      for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_saved_files_equal_a_one_process_save(sdxl, tmp_path):
    """A one-process run that restores the 2-rank run's step-2 state and
    saves it writes the same checkpoint bytes, and a full state equal to
    the one the ranks gathered (the optimizer's shards in one process's
    layout)."""
    from tests.torch_port_dist import _sdxl_args
    _, imgs, ranks = sdxl
    other = pathlib.Path(ranks[0]['exp'])
    exp = tmp_path / 'exp_sdxl'
    shutil.copytree(other, exp)
    for name in ('ckpts/unet-3.safetensors', 'state/state_3.pt'):
        os.remove(exp / name)
    trainer = main(_sdxl_args({'imgs': str(imgs)}, exp, 'train.train_steps=2',
                              'train.save_step=2', 'train.resume.auto=true'))
    assert trainer.start_step == 2 and trainer.dp is None
    flat = torch.cat([t.detach().reshape(-1) for t in pack_leaves(trainer.state.pack)])
    assert torch.equal(flat, ranks[0]['first_pack'])
    trainer.save_model(2)
    assert filecmp.cmp(exp / 'ckpts' / 'unet-2.safetensors',
                       other / 'ckpts' / 'unet-2.safetensors', shallow=False)
    assert _same(torch.load(exp / 'state' / 'state_2.pt', weights_only=True),
                 torch.load(other / 'state' / 'state_2.pt', weights_only=True))


def test_preemption_on_one_rank_stops_every_rank(tmp_path):
    imgs = write_images(tmp_path)
    ranks = launch('preempt', W, tmp_path, imgs=str(imgs))
    assert [r['stopped'] for r in ranks] == [4, 4]
    assert [r['preempted'] for r in ranks] == [True, True]
    assert ranks[0]['states'] == [4]


def test_dryrun_on_a_data_by_fsdp_grid():
    """parallel/dryrun.py: one tiny LoRA step on 4 gloo ranks as a 2 x 2
    (data, fsdp) grid under ZeRO 3: each rank holds about half of the pack,
    of the optimizer state and of the frozen base."""
    import json
    import subprocess
    import sys
    from tests.torch_port_dist import LAUNCH_TIMEOUT, ROOT
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-m', 'hcpdiff_tpu_torch.parallel.dryrun', '--ranks',
                          '4', '--fsdp', '2', '--zero', '3'], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=LAUNCH_TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['mesh'] == {'data': 2, 'fsdp': 2} and np.isfinite(out['loss'])
    held, whole = out['bytes_held_by_rank_0'], out['bytes_whole']
    for key in ('pack', 'optimizer_state', 'frozen'):
        assert 0.25 * whole[key] < held[key] < 0.75 * whole[key], (key, held, whole)


# ------------------------------------------------- in one process ----
@pytest.mark.parametrize('seed', range(4))
def test_owners_balance_bytes(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(1, 10_000, 37)]
    for n in (2, 3, 8):
        own = owners(sizes, n)
        loads = [sum(s for s, o in zip(sizes, own) if o == r) for r in range(n)]
        assert sum(loads) == sum(sizes)
        assert max(loads) <= sum(sizes) / n + max(sizes)


def test_zero_level_and_mesh_in_one_process():
    assert zero_level({'zero': 3}) == 3 and zero_level({'zero1': True}) == 1
    assert zero_level({}) == 0
    with pytest.raises(ValueError, match='expected 0, 1, 2 or 3'):
        zero_level({'zero': 4})
    mesh = pm.make_mesh()
    assert mesh.shape == {'data': 1, 'fsdp': 1} and mesh.group('data') is None
    with pytest.raises(ValueError, match='!= 1 processes'):
        pm.make_mesh(data=2)
    assert pm.local_slice(6, mesh) == (0, 6) and pm.pad_to_multiple(5, 4) == 8
    assert pm.broadcast_string('x') == 'x' and pm.gather_to_host(3) == [3]


def test_optimizer_groups_follow_pack_leaves():
    t = lambda n: torch.zeros(n)  # noqa: E731
    pack = {'lora_unet': {'a': {'down': t(1), 'up': t(2)}}, 'emb': t(3), 'unet_ft': {'w': t(4)}}
    assert optimizer_groups(pack, True) == ([[1, 2], [3]], [[0]])
    assert optimizer_groups(pack, False) == ([[1, 2, 3]], [[0]])
