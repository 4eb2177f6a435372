"""End-to-end training in the port on the CPU: the reference's
``test_end_to_end_training_reduces_loss`` (``tests/test_system.py``)
ported, with its loss drop and its resume from checkpoint; a checkpoint
of ``(params, opt_state)`` with int8 moments written by either package
and restored by the other, bit for bit; and the ``train_lm`` and
``quickstart`` examples at a small size."""
import dataclasses

import jax
import numpy as np
import torch

from repro import checkpoint as jcheckpoint
from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import init_params as jinit_params
from repro_torch import checkpoint, configs, optim
from repro_torch.core import prng
from repro_torch.data import DataConfig, batch_for_model
from repro_torch.examples import quickstart, train_lm
from repro_torch.launch import steps
from repro_torch.models import convert, init_params
from repro_torch.runtime import FaultConfig, FaultTolerantRunner
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_end_to_end_training_reduces_loss(tmp_path):
    """Train a small qwen3-family model for 60 steps through the
    fault-tolerant runner: loss must drop substantially; a restart from
    checkpoint must continue, not regress."""
    cfg = configs.get_smoke("qwen3_4b")
    dcfg = DataConfig(seed=1, seq_len=64, global_batch=8,
                      vocab_size=cfg.vocab_size)
    ocfg = optim.OptConfig.from_model(cfg, lr=3e-3, warmup_steps=10,
                                      total_steps=120, weight_decay=0.01)
    assert ocfg.moment_dtype == "float32"
    params = init_params(cfg, prng.PRNGKey(0, device="cpu"))
    opt_state = optim.init(params, ocfg)
    fn, _ = steps.build_train_step(cfg, opt_cfg=ocfg, device="cpu")

    def train_step(state, batch):
        p, s, metrics = fn(*state, batch)
        return (p, s), metrics

    def batch_fn(step):
        return {k: torch.from_numpy(v)
                for k, v in batch_for_model(cfg, dcfg, step).items()}

    def runner():
        return FaultTolerantRunner(
            FaultConfig(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=25),
            step_fn=train_step, batch_fn=batch_fn,
            state_template=(params, opt_state))

    losses = []
    runner().run(60, on_step=lambda s: losses.append(s.metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.5, (first, last)

    # restart resumes from the checkpoint, loss stays near the tail
    runner2 = runner()
    assert runner2.resume_step() == 60   # saved at 24, 49 and 59
    more = []
    runner2.run(65, on_step=lambda s: more.append(s.metrics["loss"]))
    assert len(more) == 5
    assert np.mean(more) < first - 0.4


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_checkpoint_crosses_packages_with_int8_moments(tmp_path):
    """(params, opt_state) with int8 moments, factored v and float32
    masters, after one update: saved by the JAX package and restored by
    the port, and saved by the port and restored by the JAX package,
    every leaf bit for bit (bf16 crosses as float32, exactly)."""
    jcfg = jconfigs.get_smoke("qwen3_4b")
    kw = dict(moment_dtype="int8", factored_second_moment=True)
    jocfg = joptim.OptConfig.from_model(jcfg, **kw)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    js = joptim.init(jp, jocfg)

    @jax.jit
    def one_update(p, s):
        return joptim.update(jax.tree.map(lambda x: x * 0.01 + 0.001, p),
                             s, p, jocfg)

    jp, js = one_update(jp, js)
    jcheckpoint.save(tmp_path / "jax", 3, (jp, js))

    ocfg = optim.OptConfig.from_model(configs.get_smoke("qwen3_4b"), **kw)
    p0 = init_params(configs.get_smoke("qwen3_4b"),
                     prng.PRNGKey(1, device="cpu"))
    template = (p0, optim.init(p0, ocfg))
    (p, s), _ = checkpoint.restore(tmp_path / "jax", template)
    want = (convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                    device="cpu"),
            convert.opt_state_from_jax(jax.tree.map(np.asarray, js),
                                       device="cpu"))
    got_leaves, want_leaves = _leaves((p, s)), _leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves(
        (jp, js)))
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert any(t.dtype == torch.int8 for t in got_leaves)

    checkpoint.save(tmp_path / "port", 4, (p, s))
    (jp2, js2), _ = jcheckpoint.restore(tmp_path / "port", (jp, js))
    for a, b in zip(jax.tree.leaves((jp2, js2)), jax.tree.leaves((jp, js))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = convert.opt_state_to_numpy(s)
    for a, b in zip(_leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_lm_example_trains_and_resumes(tmp_path, capsys):
    """``train_lm.train`` at the smoke config on the CPU: finite metrics,
    a checkpoint at the end, and a second call resumes after it."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3_4b"),
                              micro_batches=2)
    out = train_lm.train(cfg, steps=3, seq=32, batch=4,
                         ckpt=str(tmp_path / "ck"), log_every=1,
                         device="cpu")
    assert out["start"] == 0 and len(out["history"]) == 3
    assert all(np.isfinite(h.metrics["loss"]) and h.metrics["grad_norm"] > 0
               for h in out["history"])
    again = train_lm.train(cfg, steps=5, seq=32, batch=4,
                           ckpt=str(tmp_path / "ck"), log_every=0,
                           device="cpu")
    assert again["start"] == 3 and [h.step for h in again["history"]] \
        == [3, 4]
    assert "loss" in capsys.readouterr().out
    assert train_lm.scale_config("10m").param_count() < 2e7


def test_quickstart_training_runs():
    losses = quickstart.train_demo(steps=3, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
