"""``repro_torch.examples.train_lm`` against the JAX package's
``examples/train_lm.py``: the same ~100M configuration field for field, and
a CPU run of the example's loop at a tiny override of that configuration
(2 layers, d_model 48), saved and resumed once from its checkpoint
directory in the JAX package's layout."""
import dataclasses
import importlib.util
import os

import numpy as np
import torch

from repro.models import model_defs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.examples import train_lm
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
