"""The port's synthetic data streams equal the reference's exactly: the
same seeded numpy generator calls in the same order, so both packages
train on the same batches."""
import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data as tdata


@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (1024, 2, 16, 0), (50, 3, 7, 5), (32000, 1, 32, 11)])
def test_token_stream_equals_reference(vocab, batch, seq, seed):
    a = tdata.TokenStream(vocab=vocab, batch=batch, seq=seq, seed=seed)
    b = jdata.TokenStream(vocab=vocab, batch=batch, seq=seq, seed=seed)
    got, want = a.batches(3), b.batches(3)
    for (tk, lb), (wt, wl) in zip(got, want):
        assert tk.dtype == lb.dtype == np.int32
        assert tk.shape == lb.shape == (batch, seq)
        np.testing.assert_array_equal(tk, wt)
        np.testing.assert_array_equal(lb, wl)
        np.testing.assert_array_equal(tk[:, 1:], lb[:, :-1])
        assert tk.min() >= 0 and tk.max() < vocab


@pytest.mark.parametrize("kw", [dict(batch=2, seed=0),
                                dict(batch=3, image=8, channels=1,
                                     n_classes=4, seed=9)])
def test_image_stream_equals_reference(kw):
    ia, ib = iter(tdata.ImageStream(**kw)), iter(jdata.ImageStream(**kw))
    for _ in range(2):
        (x, y), (wx, wy) = next(ia), next(ib)
        assert x.dtype == np.float32 and y.dtype == np.int32
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
