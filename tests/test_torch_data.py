"""The port's data pipeline (``repro_torch.data``) against the
reference's ``repro.data``, on the CPU: the corpora and every batch
equal bit for bit (they are numpy on both sides)."""

import numpy as np
import pytest

from repro.data import PrefetchIterator as JaxPrefetch
from repro.data import TokenDataset as JaxTokenDataset
from repro.data import synthetic as jsyn
from repro_torch.data import PrefetchIterator, TokenDataset
from repro_torch.data import synthetic


@pytest.mark.parametrize("seed", [0, 3])
def test_corpora_equal_the_reference(seed):
    np.testing.assert_array_equal(
        synthetic.zipf_ngram_corpus(100, 3000, seed=seed, branching=8),
        jsyn.zipf_ngram_corpus(100, 3000, seed=seed, branching=8))
    np.testing.assert_array_equal(
        synthetic.zipf_ngram_corpus(50, 500, seed=seed, branching=3),
        jsyn.zipf_ngram_corpus(50, 500, seed=seed, branching=3))
    np.testing.assert_array_equal(synthetic.bytes_corpus(4000, seed=seed),
                                  jsyn.bytes_corpus(4000, seed=seed))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("source", ["zipf", "bytes"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_batches_state_and_restore_equal_the_reference(source, shard):
    index, shards = shard
    kw = dict(source=source, seed=7, corpus_tokens=5000,
              shard_index=index, num_shards=shards)
    port = TokenDataset(256, 32, 8, **kw)
    ref = JaxTokenDataset(256, 32, 8, **kw)
    np.testing.assert_array_equal(port.corpus, ref.corpus)
    for step in (0, 5, 10**6):
        _equal(port.batch_at(step), ref.batch_at(step))
    for _ in range(3):
        _equal(next(port), next(ref))
    assert port.state == ref.state == {"step": 3}
    assert port.batch_at(0)["inputs"].shape == (8 // shards, 32)
    port.restore({"step": 1})
    ref.restore({"step": 1})
    _equal(next(port), next(ref))
    assert port.state == {"step": 2}


def test_dataset_refusals_match_the_reference():
    for cls in (TokenDataset, JaxTokenDataset):
        with pytest.raises(ValueError, match="divide"):
            cls(64, 8, 6, corpus_tokens=100, num_shards=4)
        with pytest.raises(ValueError, match="unknown source"):
            cls(64, 8, 4, corpus_tokens=100, source="wiki")


def test_prefetch_gives_the_same_stream():
    port = PrefetchIterator(TokenDataset(64, 16, 4, corpus_tokens=2000),
                            prefetch=2)
    ref = JaxPrefetch(JaxTokenDataset(64, 16, 4, corpus_tokens=2000),
                      prefetch=2)
    try:
        for _ in range(4):
            _equal(next(port), next(ref))
    finally:
        port.close()
        ref.close()
    finite = PrefetchIterator(iter([{"x": np.zeros(1)}]))
    assert next(finite)["x"].shape == (1,)
    with pytest.raises(StopIteration):
        next(finite)


def test_a_large_vocabulary_zipf_corpus_repeats_no_context():
    """Over train_lm's 32768-token vocabulary no (prev, cur) context of
    the order-2 chain recurs inside the corpus: a model learns it only
    by seeing the same windows again (``chip_smoke.py``'s
    ``TRAIN_LM_CORPUS``)."""
    for length, distinct in ((50_000, 49_999), (200_000, 199_973)):
        corpus = synthetic.zipf_ngram_corpus(32768, length, seed=0)
        pairs = corpus[:-1].astype(np.int64) * 32768 + corpus[1:]
        assert len(np.unique(pairs)) == distinct
