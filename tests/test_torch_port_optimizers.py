"""The port's Lion, Adafactor, 8-bit AdamW, D-Adaptation and Prodigy
(``trainer/optim_classes.py``) against the optax transforms the JAX
package's factories build (``hcpdiff_tpu/trainer/optimizers.py``), on the
CPU in fp32:

- 10 steps on seeded leaves of the shapes a pack holds (one at least
  128x128, one with a single axis of 128 or more, a 4-D conv-LoRA factor,
  a vector and a scalar ``alpha``), under a warm-up schedule (a linear
  warm-up from 0; D-Adaptation and Prodigy take optax's one-cycle warm-up,
  which starts above 0: from lr 0 their first ``d`` is 0 / 0, NaN in optax
  as here), after
  ``clip_by_global_norm`` (optax's chain, the port's
  ``clip_by_global_norm_``): every parameter and every state value (the
  moments, the bf16 first moment, the factored row and column statistics,
  ``d`` and its numerator, Prodigy's initial parameters) within atol 1e-6
  + rtol 1e-5;
- two pack keys under D-Adaptation and Prodigy against
  ``optax.multi_transform``: one ``d`` per key, as in the JAX trainer;
- a state saved after 2 of 3 steps by the trainer's ``StateManager`` and
  loaded into a new optimizer continues bitwise (Lion, 8-bit AdamW,
  Prodigy);
- ``resolve_optimizer`` takes every name and class path of the JAX
  registry and raises for an unknown one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hcpdiff_tpu.trainer import optimizers as jopt
from hcpdiff_tpu_torch.ckpt.manager import StateManager
from hcpdiff_tpu_torch.trainer import optimizers as topt
from hcpdiff_tpu_torch.trainer.optim_classes import AdamWBf16
from tests.torch_port_common import one_torch_thread  # noqa: F401

SHAPES = {'a_big': (160, 136), 'b_one': (8, 192), 'c_conv': (4, 3, 3, 3), 'd_vec': (16,),
          'e_alpha': ()}
NAMES = ['lion', 'adafactor', 'adamw_8bit', 'dadapt_adamw', 'prodigy']
KWARGS = {'lion': {'betas': (0.9, 0.99), 'weight_decay': 1e-2},
          'adafactor': {'weight_decay': 1e-2},
          'adamw_8bit': {'betas': (0.9, 0.999), 'weight_decay': 1e-2},
          'dadapt_adamw': {'weight_decay': 1e-2},
          'prodigy': {'weight_decay': 1e-2}}
LR = {'lion': 3e-3, 'adafactor': 1e-2, 'adamw_8bit': 1e-2, 'dadapt_adamw': 1.0, 'prodigy': 1.0}
# optax state field -> the port's state key
FIELDS = {'mu': 'exp_avg', 'nu': 'exp_avg_sq', 'exp_avg': 'exp_avg', 'exp_avg_sq': 'exp_avg_sq',
          'grad_sum': 'grad_sum', 'params0': 'params0', 'v_row': 'v_row', 'v_col': 'v_col',
          'v': 'v'}
STEPS = 10


def _leaves(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s) * 0.5, np.float32) for k, s in shapes.items()}


def _grads(step, shapes=SHAPES):
    """Seeded gradients: a fixed direction plus noise (so D-Adaptation's
    and Prodigy's ``d`` grows); every third step's global norm is below
    the clip."""
    base, noise = _leaves(99, shapes), _leaves(100 + step, shapes)
    scale = 0.01 if step % 3 == 0 else 1.0
    return {k: np.asarray((base[k] + 0.5 * noise[k]) * scale, np.float32) for k in shapes}


def _schedule(lr, name):
    return dict(name='one_cycle' if name in ('dadapt_adamw', 'prodigy') else
                'constant_with_warmup', lr=lr, warmup_steps=3, training_steps=STEPS)


def _jax_run(tx, params, steps, shapes=SHAPES):
    params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(params)

    @jax.jit
    def step(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    for i in range(steps):
        params, state = step(params, state, {k: jnp.asarray(v) for k, v in _grads(i, shapes).items()})
    return params, state


def _port_step(opt, params, grads, lrs):
    """What the train step does: optax's global-norm clip, the groups' lrs,
    one step."""
    grads = [torch.from_numpy(g) for g in grads]
    topt.clip_by_global_norm_(grads, 1.0)
    for p, g in zip(params, grads):
        p.grad = g
    for group, lr in zip(opt.param_groups, lrs):
        group['lr'] = lr
    opt.step()


def _port_run(name, params, steps, groups=None, shapes=SHAPES, opt=None, start=0):
    """``groups``: {label: [leaf names]}, one parameter group each (sorted
    labels), each under its own schedule of LR[name] times its factor."""
    fn, kw = topt.resolve_optimizer({'_target_': f'optim.{name}', **KWARGS[name]})
    groups = groups or {'all': sorted(shapes)}
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    factors = {label: 1.0 + i for i, label in enumerate(sorted(groups))}
    schedules = [topt.make_schedule(**_schedule(LR[name] * factors[label], name))
                 for label in sorted(groups)]
    if opt is None:
        opt = topt.make_optimizer(fn, lr=0.0, **kw).init(
            [{'params': [tensors[k] for k in groups[label]], 'lr': 0.0}
             for label in sorted(groups)])
    else:
        tensors = {k: p for label in sorted(groups)
                   for k, p in zip(groups[label], opt.param_groups[sorted(groups).index(label)]['params'])}
    order = [k for label in sorted(groups) for k in groups[label]]
    for i in range(start, start + steps):
        g = _grads(i, shapes)
        _port_step(opt, [tensors[k] for k in order], [g[k] for k in order],
                   [s(i) for s in schedules])
    return tensors, opt


def _close(got, want, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5, err_msg=what)


def _named_states(state):
    """Every NamedTuple of an optax state, depth first."""
    if hasattr(state, '_fields'):
        yield state
    if isinstance(state, (tuple, list)):
        for s in state:
            yield from _named_states(s)
    elif isinstance(state, dict):
        for s in state.values():
            yield from _named_states(s)


def _check_state(opt, jstate, tensors, leaf_names):
    head = opt.state[tensors[leaf_names[0]]]
    checked = set()
    for st in _named_states(jstate):
        for field in st._fields:
            value = getattr(st, field)
            if field in FIELDS and isinstance(value, dict):
                for k in leaf_names:
                    mine = opt.state[tensors[k]].get(FIELDS[field])
                    if mine is None:     # optax's (1,) placeholders of the other layout
                        assert np.asarray(value[k]).shape == (1,), (field, k)
                        continue
                    if field == 'mu' and isinstance(opt, AdamWBf16):
                        assert mine.dtype == torch.bfloat16
                        assert np.asarray(value[k]).dtype == jnp.bfloat16
                    _close(mine, value[k], f'{field}[{k}]')
                    checked.add(field)
            elif field in ('estim_lr', 'numerator_weighted'):
                _close(head[{'estim_lr': 'd', 'numerator_weighted': 'numerator'}[field]], value,
                       field)
                checked.add(field)
    return checked


@pytest.mark.parametrize('name', NAMES)
def test_optimizer_matches_optax(name):
    params0 = _leaves(7)
    sched = jopt.make_schedule(**_schedule(LR[name], name))
    fn, kw = jopt.resolve_optimizer({'_target_': f'optim.{name}', **KWARGS[name]})
    tx = jopt.make_optimizer(fn, schedule=sched, clip_norm=1.0, **kw)
    jparams, jstate = _jax_run(tx, params0, STEPS)
    tensors, opt = _port_run(name, params0, STEPS)
    for k in SHAPES:
        _close(tensors[k], jparams[k], f'param {k}')
        assert not np.array_equal(tensors[k].numpy(), params0[k]), k
    checked = _check_state(opt, jstate, tensors, sorted(SHAPES))
    expect = {'lion': {'mu'}, 'adamw_8bit': {'mu', 'nu'}, 'adafactor': {'v_row', 'v_col', 'v'},
              'dadapt_adamw': {'exp_avg', 'exp_avg_sq', 'grad_sum', 'estim_lr',
                               'numerator_weighted'},
              'prodigy': {'exp_avg', 'exp_avg_sq', 'grad_sum', 'params0', 'estim_lr',
                          'numerator_weighted'}}[name]
    assert checked == expect
    if name == 'adafactor':     # factored only where both largest axes reach 128
        assert set(opt.state[tensors['a_big']]) == {'step', 'v_row', 'v_col'}
        assert all(set(opt.state[tensors[k]]) == {'step', 'v'} for k in SHAPES if k != 'a_big')


@pytest.mark.parametrize('name', ['dadapt_adamw', 'prodigy'])
def test_distance_estimate_is_per_pack_key(name):
    """Two pack keys, each its own optax instance under multi_transform (the
    JAX trainer's layout) and its own parameter group here: each key's
    ``d`` and numerator as optax's, and the two differ."""
    groups = {'lora_te': ['c_conv', 'd_vec'], 'lora_unet': ['a_big', 'b_one', 'e_alpha']}
    params0 = _leaves(8)
    fn, kw = jopt.resolve_optimizer({'_target_': f'optim.{name}', **KWARGS[name]})
    txs = {label: jopt.make_optimizer(fn, schedule=jopt.make_schedule(
        **_schedule(LR[name] * (1.0 + i), name)), **kw) for i, label in enumerate(sorted(groups))}
    of = {k: label for label, ks in groups.items() for k in ks}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.multi_transform(txs, lambda p: {k: of[k] for k in p}))
    jparams, jstate = _jax_run(tx, params0, STEPS)
    tensors, opt = _port_run(name, params0, STEPS, groups=groups)
    for k in SHAPES:
        _close(tensors[k], jparams[k], f'param {k}')
    inner = jstate[1].inner_states
    ds = []
    for label in sorted(groups):
        checked = _check_state(opt, inner[label], tensors, groups[label])
        assert {'estim_lr', 'numerator_weighted'} <= checked
        ds.append(float(opt.state[tensors[groups[label][0]]]['d']))
    assert ds[0] != ds[1] and all(d > 1e-6 for d in ds)


@pytest.mark.parametrize('name', ['lion', 'adamw_8bit', 'prodigy'])
def test_resumed_state_continues_bitwise(name, tmp_path):
    """3 steps in one go against 2 steps, the state through the trainer's
    ``StateManager`` (torch.save, loaded to the CPU) and load_state_dict
    into a fresh optimizer over fresh tensors, then the third step: the
    same parameters and state, bit for bit."""
    params0 = _leaves(9)
    whole, opt_whole = _port_run(name, params0, 3)
    cut, opt_cut = _port_run(name, params0, 2)
    states = StateManager(str(tmp_path))
    states.save(2, {'optimizer': opt_cut.state_dict()})
    saved = states.restore(2)['optimizer']
    fn, kw = topt.resolve_optimizer({'_target_': f'optim.{name}', **KWARGS[name]})
    fresh = {k: v.detach().clone() for k, v in cut.items()}
    opt = topt.make_optimizer(fn, lr=0.0, **kw).init(
        [{'params': [fresh[k] for k in sorted(SHAPES)], 'lr': 0.0}])
    opt.load_state_dict(saved)
    rest, opt = _port_run(name, params0, 1, opt=opt, start=2)
    for k in SHAPES:
        assert torch.equal(rest[k], whole[k]), k
        a, b = opt.state[rest[k]], opt_whole.state[whole[k]]
        assert sorted(a) == sorted(b)
        for key in a:
            if torch.is_tensor(a[key]):
                assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), (k, key)
            else:
                assert a[key] == b[key]


JAX_PATHS = ['optim.adamw', 'optim.adam', 'optim.lion', 'optim.sgd', 'optim.adafactor',
             'optim.adamw_8bit', 'optim.dadapt_adamw', 'optim.prodigy', 'torch.optim.AdamW',
             'torch.optim.Adam', 'torch.optim.SGD', 'lion_pytorch.Lion',
             'bitsandbytes.optim.AdamW8bit', 'dadaptation.DAdaptAdam', 'dadaptation.DAdaptAdamW',
             'prodigyopt.Prodigy', 'transformers.optimization.Adafactor', 'lion', 'prodigy',
             'bitsandbytes.optim.Adam8bit']


@pytest.mark.parametrize('path', JAX_PATHS)
def test_every_registry_path_resolves_as_in_jax(path):
    jfn, _ = jopt.resolve_optimizer({'_target_': path})
    tfn, _ = topt.resolve_optimizer({'_target_': path})
    assert tfn.__name__ == jfn.__name__


@pytest.mark.parametrize('path', ['optim.lamb', 'bitsandbytes.optim.Lion8bit', 'adamw9'])
def test_unknown_optimizer_raises(path):
    with pytest.raises(ValueError, match='cannot resolve optimizer'):
        topt.resolve_optimizer({'_target_': path})
