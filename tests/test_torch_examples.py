"""``repro_torch.examples.train_lm`` against the JAX package's
``examples/train_lm.py``: the same ~100M configuration field for field, and
a CPU run of the example's loop at a tiny override of that configuration
(2 layers, d_model 48), saved and resumed once from its checkpoint
directory in the JAX package's layout.  ``repro_torch.examples.serve_llm``
on the CPU: its own run to the end of its asserts, and its traffic at
temperature 0 against the JAX engine's on the same float32 parameters
(carried across by ``from_jax_params``): the same greedy tokens for all
nine requests (the JAX run's top-2 logit gap above 1e-3 at every step, so
no comparison rests on a near tie)."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import init_tree, model_defs
from repro.runtime import ServeEngine as JServeEngine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.examples import serve_llm, train_lm
from repro_torch.models import from_jax_params
from repro_torch.models.config import ModelConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm", os.path.join(ROOT, "examples", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_100m_is_the_jax_examples():
    got, want = train_lm.config_100m(), _jax_example().config_100m()
    for f in ModelConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert got.param_count() == want.param_count()
    assert (got.n_layers, got.d_model, got.n_heads, got.n_kv_heads,
            got.head_dim, got.vocab) == (16, 672, 8, 4, 84, 16384)
    assert set(model_defs(want)["layers"]) == {"ln1", "attn", "ln2", "ffn"}


def test_train_lm_saves_and_resumes_on_the_cpu(tmp_path, capsys):
    tiny = dataclasses.replace(train_lm.config_100m(), n_layers=2,
                               d_model=48, n_heads=4, n_kv_heads=2,
                               head_dim=12, d_ff=96, vocab=256)
    args = ["--batch", "4", "--seq-len", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    first = train_lm.main(["--steps", "6", *args], cfg=tiny)
    assert first["start"] == 0
    assert CheckpointManager(str(tmp_path)).steps() == [6]
    second = train_lm.main(["--steps", "10", *args], cfg=tiny)
    out = capsys.readouterr().out
    assert second["start"] == 6
    assert "[example] resumed from step 6" in out
    assert CheckpointManager(str(tmp_path), keep=2).steps() == [6, 10]
    logged = [ln for ln in out.splitlines() if ln.startswith("step")]
    # steps 0 and 5 of the first run, step 9 of the second
    assert [int(ln.split()[1]) for ln in logged] == [0, 5, 9]
    for r in (first, second):
        assert np.isfinite(r["first_loss"]) and np.isfinite(r["final_loss"])


def test_serve_llm_runs_on_the_cpu(capsys):
    engine = serve_llm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] 3 more requests joined at step 5" in out
    assert "serve example OK" in out
    assert len(engine.finished) == 9
    assert all(len(r.out) == r.max_new for r in engine.finished)


def _jax_serve(cfg, params):
    """The reference example's traffic through the JAX engine, at
    temperature 0 (its loop, as ``serve_llm.serve`` runs it)."""
    engine = JServeEngine(cfg, params, slots=serve_llm.SLOTS,
                          capacity=serve_llm.CAPACITY, temperature=0.0,
                          seed=serve_llm.SEED)
    gaps = []
    decode = engine._decode

    def recorded(*a):
        logits, cache = decode(*a)
        top2 = np.sort(np.asarray(logits, dtype=np.float32), axis=-1)
        live = [i for i, r in enumerate(engine.active) if r is not None]
        gaps.extend((top2[live, -1] - top2[live, -2]).tolist())
        return logits, cache
    engine._decode = recorded
    rng = np.random.default_rng(serve_llm.SEED)
    for _ in range(6):
        plen = int(rng.integers(4, 24))
        engine.submit(rng.integers(0, cfg.vocab, plen).tolist(),
                      max_new=int(rng.integers(6, 20)))
    steps = 0
    while engine.queue or any(s is not None for s in engine.active):
        engine.step()
        steps += 1
        if steps == serve_llm.JOIN_STEP:
            for _ in range(serve_llm.LATE):
                engine.submit(rng.integers(0, cfg.vocab, 8).tolist(),
                              max_new=8)
    return engine, gaps


def test_serve_llm_greedy_tokens_equal_jax_engine():
    jcfg = jget_smoke(serve_llm.ARCH)
    params = init_tree(jax.random.PRNGKey(0), model_defs(jcfg),
                       dtype=jnp.float32)
    want, gaps = _jax_serve(jcfg, params)
    cfg = get_smoke(serve_llm.ARCH)
    model = from_jax_params(cfg, jax.device_get(params))
    got, steps, joined_at = serve_llm.serve(cfg, model, "cpu",
                                            temperature=0.0)
    assert joined_at == serve_llm.JOIN_STEP
    assert len(got.finished) == len(want.finished) == 9
    assert all(len(r.out) == r.max_new for r in got.finished)
    assert min(gaps) > 1e-3          # the active slots' top-2 gaps
    assert {r.rid: r.out for r in got.finished} == \
        {r.rid: r.out for r in want.finished}
