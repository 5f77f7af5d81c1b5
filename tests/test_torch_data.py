"""The port's data pipeline (`repro_torch.data.pipeline`) against the JAX
package's: the same seeds give bit-equal batches (numpy draws in the same
order), hosts draw disjoint streams, labels are the shifted tokens, and the
byte corpus and the prefetch thread behave as the reference's."""

import numpy as np
import pytest

from repro.data import pipeline as JD
from repro_torch.data.pipeline import (ByteCorpus, DataConfig, Prefetcher,
                                       SyntheticCorpus, batch_iterator)


@pytest.mark.parametrize("seed,host,hosts", [(0, 0, 1), (3, 0, 2), (3, 1, 2),
                                             (7, 2, 4)])
@pytest.mark.parametrize("vocab", [64, 512])
def test_batches_bit_equal_to_the_reference(seed, host, hosts, vocab):
    kw = dict(vocab=vocab, seq_len=24, batch_size=3, seed=seed, host_id=host,
              num_hosts=hosts)
    got = batch_iterator(SyntheticCorpus(vocab, seed=seed), DataConfig(**kw))
    want = JD.batch_iterator(JD.SyntheticCorpus(vocab, seed=seed),
                             JD.DataConfig(**kw))
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_corpus_tables_equal_the_reference():
    got, want = SyntheticCorpus(300, seed=5), JD.SyntheticCorpus(300, seed=5)
    for k in ("succ", "succ_p", "base_p"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_host_streams_are_disjoint():
    corpus = SyntheticCorpus(64, seed=0)
    b0 = next(batch_iterator(corpus, DataConfig(64, 16, 4, host_id=0,
                                                num_hosts=2)))
    b1 = next(batch_iterator(corpus, DataConfig(64, 16, 4, host_id=1,
                                                num_hosts=2)))
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_labels_are_shifted_tokens():
    b = next(batch_iterator(SyntheticCorpus(64, seed=0), DataConfig(64, 16, 2)))
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_byte_corpus_matches_the_reference(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"hello world, this is a tiny corpus for testing" * 10)
    got = ByteCorpus(str(p)).sample(np.random.default_rng(0), 32)
    want = JD.ByteCorpus(str(p)).sample(np.random.default_rng(0), 32)
    assert got.shape == (32,) and got.dtype == np.int32 and got.max() < 256
    np.testing.assert_array_equal(got, want)
    (tmp_path / "one").write_bytes(b"x")
    with pytest.raises(ValueError):
        ByteCorpus(str(tmp_path / "one"))


def test_prefetcher_order_and_end():
    out = list(Prefetcher(iter([{"x": i} for i in range(5)]), depth=2))
    assert [o["x"] for o in out] == [0, 1, 2, 3, 4]


def test_prefetcher_close_stops_a_blocked_thread():
    """An endless source fills the queue and blocks the thread; close()
    drains it and the thread ends."""
    pf = Prefetcher(iter(lambda: {"x": 0}, None), depth=2)
    assert next(pf) == {"x": 0}
    pf.close(timeout=10)
    assert not pf.thread.is_alive()
