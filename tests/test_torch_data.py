"""The port's synthetic data pipeline against the JAX package's, bit for
bit: its numpy threefry2x32 against ``jax.random`` (JAX's defaults:
threefry2x32, partitionable bits), and ``batch_at`` / ``host_shard_batch``
/ ``SyntheticLM`` element for element.  The tokens are integers and the
reference is exact, so every comparison is equality."""
import jax
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import batch_at as jbatch_at
from repro.data import host_shard_batch as jhost_shard_batch
from repro_torch.data import (DataConfig, SyntheticLM, batch_at,
                              host_shard_batch)
from repro_torch.data import pipeline as P


def key_words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)
                                            if hasattr(jax.random,
                                                       "key_data")
                                            else key))


def test_jax_runs_the_settings_the_port_reproduces():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 32 + 7])
def test_threefry_primitives_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    k = P.prng_key(seed)
    assert key_words(key) == k
    for data in (0, 1, 2, 977, 2 ** 31 + 5):
        assert key_words(jax.random.fold_in(key, data)) == P.fold_in(k, data)
    assert [key_words(s) for s in jax.random.split(key, 3)] == \
        P.split(k, 3)
    for shape in ((7,), (3, 5), (4, 33)):
        assert np.array_equal(np.asarray(jax.random.bits(key, shape)),
                              P.random_bits(k, shape))
        u = P.uniform(k, shape)
        assert u.dtype == np.float32
        assert np.array_equal(np.asarray(jax.random.uniform(key, shape)), u)
    for lo, hi in ((0, 97), (3, 515), (-5, 2 ** 20)):
        got = P.randint(k, (6, 2), lo, hi)
        assert got.dtype == np.int32
        assert np.array_equal(
            np.asarray(jax.random.randint(key, (6, 2), lo, hi)), got)


@pytest.mark.parametrize("seed", [0, 3, 41])
@pytest.mark.parametrize("step", [0, 1, 17])
def test_batch_at_matches_jax(seed, step):
    kw = dict(vocab=515, seq_len=33, global_batch=4, seed=seed)
    got, want = batch_at(DataConfig(**kw), step), \
        jbatch_at(JDataConfig(**kw), step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == P.torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert (got["labels"][:, -1] == -1).all()
    assert np.array_equal(got["labels"][:, :-1].numpy(),
                          got["tokens"][:, 1:].numpy())


@pytest.mark.parametrize("kw", [dict(zipf_alpha=0.0),
                                dict(markov_strength=0.0),
                                dict(vocab=49155, seq_len=16)])
def test_batch_at_variants_match_jax(kw):
    args = dict(dict(vocab=300, seq_len=24, global_batch=3, seed=5), **kw)
    got, want = batch_at(DataConfig(**args), 2), \
        jbatch_at(JDataConfig(**args), 2)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_host_shards_tile_the_global_batch():
    cfg = DataConfig(vocab=515, seq_len=16, global_batch=8, seed=2)
    jcfg = JDataConfig(vocab=515, seq_len=16, global_batch=8, seed=2)
    full = batch_at(cfg, 3)
    parts = [host_shard_batch(cfg, 3, host_index=i, host_count=4)
             for i in range(4)]
    for k in full:
        assert np.array_equal(np.concatenate([p[k].numpy() for p in parts]),
                              full[k].numpy())
        for i, p in enumerate(parts):
            want = jhost_shard_batch(jcfg, 3, host_index=i, host_count=4)
            assert np.array_equal(p[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="not divisible"):
        host_shard_batch(cfg, 0, host_index=0, host_count=3)


def test_synthetic_lm_iterates_and_resumes_like_jax():
    cfg = DataConfig(vocab=515, seq_len=8, global_batch=2, seed=1)
    it, jit = SyntheticLM(cfg), JSyntheticLM(JDataConfig(
        vocab=515, seq_len=8, global_batch=2, seed=1))
    for _ in range(3):
        got, want = next(it), next(jit)
        assert np.array_equal(got["tokens"].numpy(),
                              np.asarray(want["tokens"]))
    assert it.state_dict() == jit.state_dict() == {"step": 3}
    resumed = SyntheticLM(cfg)
    resumed.load_state_dict(it.state_dict())
    assert np.array_equal(next(resumed)["tokens"].numpy(),
                          batch_at(cfg, 3)["tokens"].numpy())
