"""`repro_torch.runtime.offload.OffloadedKVCache` on the CPU: the six
`test_offloaded_kv_cache_*` of tests/test_substrates.py against the port's
class (same bookkeeping, plain copies in place of the card's streams)."""
import numpy as np
import pytest
import torch

from repro_torch.runtime.offload import OffloadedKVCache

import test_torch_util  # noqa: F401  (keeps torch's thread count small)


def test_offloaded_kv_cache_roundtrip_and_prefetch():
    L = 6
    cache = OffloadedKVCache(num_layers=L, window=2, device="cpu")
    rng = np.random.default_rng(0)
    pages = [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(L)]
    for i, p in enumerate(pages):
        cache.host_put(i, p)
    # decode walk: fetch each layer, update it, let the window recycle
    cache.prefetch(0)
    for i in range(L):
        page = cache.fetch(i)
        np.testing.assert_array_equal(np.asarray(page), pages[i])
        cache.update(i, page + 1.0)
    cache.flush()
    for i in range(L):
        np.testing.assert_allclose(cache._host[i], pages[i] + 1.0)
    # issue-ahead actually happened: layers 1..L-1 were prefetched
    assert cache.stats["prefetch_issued"] >= L - 1
    assert cache.stats["prefetch_hits"] >= L - 1
    assert cache.stats["writebacks"] == L
    cache.close()


def test_offloaded_kv_cache_in_place_update_of_resident_page():
    """The port's pages are mutable: update() may be handed the very tensor
    that is resident, and the host copy must not alias it."""
    cache = OffloadedKVCache(num_layers=3, window=1, device="cpu")
    for i in range(3):
        cache.host_put(i, torch.full((2, 2), float(i)))
    for i in range(3):
        page = cache.fetch(i)
        page += 10.0
        cache.update(i, page)
        assert cache._host[i].data_ptr() != page.data_ptr()
    cache.flush()
    for i in range(3):
        np.testing.assert_array_equal(cache._host[i], np.full((2, 2), i + 10.0))
    assert cache.stats["writebacks"] == 3
    cache.close()


def test_offloaded_kv_cache_clean_pages_skip_writeback():
    L = 8
    cache = OffloadedKVCache(num_layers=L, window=2, device="cpu")
    rng = np.random.default_rng(1)
    pages = [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(L)]
    for i, p in enumerate(pages):
        cache.host_put(i, p)
    dirty = {1, 4, 5}
    for i in range(L):
        page = cache.fetch(i)
        if i in dirty:
            cache.update(i, page * 2.0)
    cache.flush()
    # only update()d layers were written back; clean evictions are free
    assert cache.stats["writebacks"] == len(dirty)
    for i in range(L):
        want = pages[i] * 2.0 if i in dirty else pages[i]
        np.testing.assert_allclose(cache._host[i], want)
    cache.close()


def test_offloaded_kv_cache_flush_drains_pending():
    L = 4
    cache = OffloadedKVCache(num_layers=L, window=2, device="cpu")
    for i in range(L):
        cache.host_put(i, np.full((2, 2), i, np.float32))
    cache.fetch(0)                      # issues the prefetch of layer 1
    assert 1 in cache._pending or 1 in cache._resident
    cache.flush()                       # must land the in-flight transfer
    assert cache._pending == {}
    assert cache._resident == {}
    assert cache.stats["writebacks"] == 0   # nothing was update()d
    assert cache.writebacks_in_flight() == 0
    np.testing.assert_array_equal(cache._host[1], np.full((2, 2), 1))
    cache.close()


def test_offloaded_kv_cache_missing_layer_raises_not_hangs():
    cache = OffloadedKVCache(num_layers=3, window=2, device="cpu")
    cache.host_put(0, np.zeros((2, 2), np.float32))
    # prefetched transfer of a never-host_put layer: the upload error must
    # surface at fetch() instead of being lost
    cache.prefetch(1)
    with pytest.raises(RuntimeError, match="layer 1"):
        cache.fetch(1)
    # demand path too
    with pytest.raises(RuntimeError, match="host_put"):
        cache.fetch(2)
    cache.close()


def test_offloaded_kv_cache_retries_flaky_uploads():
    class Flaky(OffloadedKVCache):
        """Upload whose first `fail_first` _upload calls die with a
        transient error — the seam the retry loop is specified against."""

        def __init__(self, *a, fail_first=0, **kw):
            super().__init__(*a, **kw)
            self._fail_left = fail_first

        def _upload(self, layer, host_page):
            if self._fail_left > 0:
                self._fail_left -= 1
                raise OSError("transient NIC hiccup")
            return super()._upload(layer, host_page)

    page = np.arange(4, dtype=np.float32).reshape(2, 2)

    # default max_retries=0: the first failure propagates at fetch()
    cache = Flaky(num_layers=1, window=1, fail_first=1, device="cpu")
    cache.host_put(0, page)
    cache.prefetch(0)
    with pytest.raises(RuntimeError, match="layer 0"):
        cache.fetch(0)
    cache.close()

    # bounded retry with backoff recovers from transient failures
    cache = Flaky(num_layers=1, window=1, fail_first=2,
                  max_retries=3, retry_backoff_s=0.0, device="cpu")
    cache.host_put(0, page)
    cache.prefetch(0)
    np.testing.assert_array_equal(np.asarray(cache.fetch(0)), page)
    assert cache.stats["prefetch_retries"] == 2
    cache.close()

    # exhaustion: persistent failure still surfaces, naming the budget
    cache = Flaky(num_layers=1, window=1, fail_first=99,
                  max_retries=2, retry_backoff_s=0.0, device="cpu")
    cache.host_put(0, page)
    cache.prefetch(0)
    with pytest.raises(RuntimeError, match="after 2 retries"):
        cache.fetch(0)
    cache.close()


def test_offloaded_kv_cache_rejects_negative_retry_knobs():
    with pytest.raises(ValueError, match="max_retries"):
        OffloadedKVCache(num_layers=1, max_retries=-1)
    with pytest.raises(ValueError, match="retry_backoff_s"):
        OffloadedKVCache(num_layers=1, retry_backoff_s=-0.5)
    with pytest.raises(ValueError, match="window"):
        OffloadedKVCache(num_layers=1, window=0)


def test_offloaded_kv_cache_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        OffloadedKVCache(num_layers=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        OffloadedKVCache(num_layers=1)          # the default is the card


def test_offloaded_kv_cache_rejects_page_on_another_device():
    cache = OffloadedKVCache(num_layers=2, window=1, device="cpu")
    meta = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="device"):
        cache.host_put(0, meta)
    cache.host_put(0, torch.zeros(2, 2))
    cache.fetch(0)
    with pytest.raises(ValueError, match="device"):
        cache.update(0, meta)
    cache.close()
