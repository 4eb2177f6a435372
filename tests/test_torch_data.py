"""The port's synthetic data pipeline (``repro_torch.data``) against the
JAX package's: both are numpy, so every batch is bit for bit the same,
over seeds, steps, host shards and the three input schemas (tokens;
audio frame embeddings; vision patch embeddings spliced over tokens).
The reference's own data test (``tests/test_substrates.py``) is ported
beside it."""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import batch_for_model as jbatch_for_model
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM, batch_for_model


def _equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("step", [0, 3, 1000])
@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_stream_bit_equal(seed, step, hosts):
    host_id, host_count = hosts
    kw = dict(seed=seed, seq_len=48, global_batch=8, vocab_size=777,
              copy_period=16)
    got = SyntheticLM(DataConfig(**kw)).batch(step, host_id=host_id,
                                              host_count=host_count)
    want = JSyntheticLM(JDataConfig(**kw)).batch(step, host_id=host_id,
                                                 host_count=host_count)
    _equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3_4b", "hubert_xlarge",
                                  "internvl2_76b", "deepseek_v3_671b"])
@pytest.mark.parametrize("step", [0, 5])
def test_batch_for_model_bit_equal(arch, step):
    """Every family's schema: token ids (a vocabulary below the stream's
    clips it), audio features, vision patch embeddings."""
    kw = dict(seed=2, seq_len=32, global_batch=4, vocab_size=50000)
    got = batch_for_model(configs.get_smoke(arch), DataConfig(**kw), step,
                          host_id=1, host_count=2)
    want = jbatch_for_model(jconfigs.get_smoke(arch), JDataConfig(**kw),
                            step, host_id=1, host_count=2)
    _equal(got, want)
    frontend = configs.get_smoke(arch).frontend
    assert ("features" in got) == (frontend == "audio")
    assert ("img_embeds" in got) == (frontend == "vision")


def test_iterator_walks_the_steps():
    cfg = DataConfig(seed=4, seq_len=16, global_batch=2, vocab_size=100)
    it = SyntheticLM(cfg).iterator(start_step=7)
    for step in (7, 8, 9):
        _equal(next(it), SyntheticLM(cfg).batch(step))


def test_uneven_host_split_raises():
    with pytest.raises(ValueError, match="divide"):
        SyntheticLM(DataConfig(global_batch=6)).batch(0, host_count=4)


def test_data_deterministic_and_sharded():
    cfg = DataConfig(seed=3, seq_len=64, global_batch=8, vocab_size=1000)
    s = SyntheticLM(cfg)
    a = s.batch(5)
    b = s.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # host sharding partitions the global batch deterministically
    h0 = s.batch(5, host_id=0, host_count=2)
    h1 = s.batch(5, host_id=1, host_count=2)
    assert h0["tokens"].shape == (4, 64)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    # next-token alignment
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])
