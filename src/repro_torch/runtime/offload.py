"""Host-DRAM far-memory tier: the paper's mechanism at runtime granularity.

KV pages live in host memory — far memory from the card's viewpoint, reached
over the host link. The :class:`OffloadedKVCache` keeps only a window of pages
resident on the device and uses the AMI pattern to hide transfer latency:

* ``aload``  -> ``prefetch()`` issues the *next* page's upload while the
  current one is in use: a ``copy_(non_blocking=True)`` from pinned host
  memory on a side CUDA stream, which returns at once;
* ``getfin`` -> a ``torch.cuda.Event`` recorded behind that copy; ``fetch()``
  makes the consumer's stream wait on that event only (the host does not
  block), so completion is decoupled from issue;
* slot ring  -> the resident window (``window`` pages), recycled in page
  order like the kernels' shared-memory rings;
* writeback  -> a dirty page retires to its pinned host copy on a second side
  stream, after waiting on an event recorded where the page was produced; the
  host copy is read again (by an upload, or by the host after ``flush()``)
  only after the writeback's own event.

The counterpart of `src/repro/runtime/offload.py`, with the same methods,
`stats` keys and error messages. ``device`` defaults to ``"cuda"`` and raises
where there is no card; with ``device="cpu"`` (the tests) the same
bookkeeping runs with plain copies. Pages that the consumer updates IN PLACE
are supported: ``update()`` may be handed the very tensor that is resident,
and a dirty page evicted while the consumer still holds it makes the
consumer's stream wait for the writeback before it can overwrite the page.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class OffloadedKVCache:
    def __init__(self, num_layers: int, window: int = 2,
                 max_retries: int = 0, retry_backoff_s: float = 0.01,
                 device="cuda"):
        """``device`` is where the resident window lives: the card by
        default, like the other entry points; the tests ask for ``"cpu"``.
        A page handed to ``host_put`` or ``update`` that lies on another
        kind of device raises. ``max_retries`` bounds how often a failed prefetch upload is
        re-issued (exponential ``retry_backoff_s * 2**attempt`` sleep
        between attempts) before the error propagates; the default 0 keeps
        the propagate-immediately behavior. Retries re-read the host page,
        so a transient fault (or a late ``host_put``) recovers."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}")
        self.num_layers = num_layers
        self.window = window
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but no CUDA "
                               "device is available")
        self._host: List[Optional[torch.Tensor]] = [None] * num_layers
        self._resident: Dict[int, torch.Tensor] = {}           # device slots
        self._dirty: set = set()                               # update()d
        # in-flight uploads: layer -> ("ok", page) | ("err", exception)
        self._pending: Dict[int, Tuple[str, Any]] = {}
        # CUDA only: events that order the copies against their users
        self._uploaded: Dict[int, Any] = {}     # getfin of an upload
        self._produced: Dict[int, Any] = {}     # page ready for writeback
        self._host_ready: Dict[int, Any] = {}   # host copy written back
        if self._cuda:
            self._up_stream = torch.cuda.Stream(self.device)
            self._wb_stream = torch.cuda.Stream(self.device)
        self.stats = {"prefetch_issued": 0, "prefetch_hits": 0,
                      "demand_fetches": 0, "writebacks": 0,
                      "prefetch_retries": 0}

    def _check_device(self, what: str, page: torch.Tensor) -> None:
        if page.device.type != self.device.type:
            raise ValueError(
                f"{what}: page on device {page.device}, but this cache "
                f"keeps its window on {self.device}")

    # ------------------------------------------------------------- far side
    def host_put(self, layer: int, page: Any) -> None:
        """Place a page in far memory (pinned host memory on a card). The
        page comes from the window's device, or from the host (a numpy
        array, or a CPU tensor that seeds far memory)."""
        if not isinstance(page, torch.Tensor):
            page = torch.from_numpy(np.array(page))
        page = page.detach()
        if page.device.type != "cpu":
            self._check_device("host_put", page)
        if self._cuda:
            host = torch.empty(page.shape, dtype=page.dtype, pin_memory=True)
            host.copy_(page)        # blocks the host: set-up, not steady state
            self._host_ready.pop(layer, None)
        else:
            host = page.cpu().clone()
        self._host[layer] = host

    def writebacks_in_flight(self) -> int:
        return sum(1 for ev in self._host_ready.values() if not ev.query())

    # ------------------------------------------------------------ AMI-style
    def _upload(self, layer: int, host_page: Any) -> Any:
        """The device copy itself — one seam for tests to make flaky."""
        if host_page is None:
            raise RuntimeError(f"layer {layer} fetched before host_put()")
        if not self._cuda:
            return host_page.clone()
        with torch.cuda.stream(self._up_stream):
            written = self._host_ready.get(layer)
            if written is not None:     # the host copy is still being written
                self._up_stream.wait_event(written)
            page = torch.empty_like(host_page, device=self.device)
            page.copy_(host_page, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._up_stream)
        self._uploaded[layer] = done
        return page

    def _issue_upload(self, layer: int) -> Tuple[str, Any]:
        # an upload must never fail silently: post the exception instead and
        # re-raise it on the consuming side, at fetch()
        try:
            return ("ok", self._upload(layer, self._host[layer]))
        except Exception as exc:  # noqa: BLE001 - posted, not dropped
            return ("err", exc)

    def prefetch(self, layer: int) -> None:
        """aload: issue the upload of `layer`'s page; returns immediately."""
        if layer >= self.num_layers or layer in self._resident \
                or layer in self._pending:
            return
        self.stats["prefetch_issued"] += 1
        self._pending[layer] = self._issue_upload(layer)

    def _take_pending(self, layer: int) -> Any:
        """Consume `layer`'s in-flight transfer, re-raising an upload error
        after `max_retries` bounded-backoff re-issues (each retry re-reads
        the current host page, so transient faults recover)."""
        status, payload = self._pending.pop(layer)
        attempt = 0
        while status == "err" and attempt < self.max_retries:
            time.sleep(self.retry_backoff_s * (2.0 ** attempt))
            attempt += 1
            self.stats["prefetch_retries"] += 1
            status, payload = self._issue_upload(layer)
        if status == "err":
            raise RuntimeError(
                f"prefetch of layer {layer} failed "
                f"(after {attempt} retries)") from payload
        return payload

    def _land(self, layer: int, page: torch.Tensor) -> None:
        """getfin: the consumer's stream waits on the upload's event only."""
        self._resident[layer] = page
        done = self._uploaded.pop(layer, None)
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            page.record_stream(cur)     # allocated on the upload stream

    def fetch(self, layer: int) -> Any:
        """getfin + SPM read: returns the resident page, waiting only if the
        issued transfer has not completed yet."""
        if layer in self._resident:
            self.stats["prefetch_hits"] += 1
        elif layer in self._pending:
            self._land(layer, self._take_pending(layer))
            self.stats["prefetch_hits"] += 1
        else:
            if self._host[layer] is None:
                raise RuntimeError(
                    f"layer {layer} fetched before host_put()")
            self.stats["demand_fetches"] += 1
            self._land(layer, self._upload(layer, self._host[layer]))
        # keep the window: issue the next prefetch, retire the oldest
        self.prefetch(layer + 1)
        while len(self._resident) > self.window:
            oldest = min(self._resident)
            if oldest == layer:
                break
            self._retire(oldest)
        return self._resident[layer]

    def _retire(self, layer: int) -> None:
        """Evict `layer` from the window: write back only if update()d —
        a clean page is already byte-identical on the host side."""
        page = self._resident.pop(layer)
        produced = self._produced.pop(layer, None)
        if layer not in self._dirty:
            return
        self._dirty.discard(layer)
        self.stats["writebacks"] += 1
        host = self._host[layer]
        if host is None or host.shape != page.shape \
                or host.dtype != page.dtype:
            host = torch.empty(page.shape, dtype=page.dtype,
                               pin_memory=self._cuda)
            self._host[layer] = host
        if not self._cuda:
            host.copy_(page)
            return
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._wb_stream):
            if produced is not None:
                self._wb_stream.wait_event(produced)
            host.copy_(page, non_blocking=True)
            written = torch.cuda.Event()
            written.record(self._wb_stream)
        page.record_stream(self._wb_stream)
        self._host_ready[layer] = written
        # whoever still holds the page may write it in place next: that must
        # come after the copy has read it
        cur.wait_event(written)

    def update(self, layer: int, page: Any) -> None:
        """astore: replace the resident page (it may be the same tensor,
        updated in place); writeback happens lazily when the slot is
        recycled."""
        self._check_device("update", page)
        self._resident[layer] = page
        self._dirty.add(layer)
        if self._cuda:
            produced = torch.cuda.Event()
            produced.record(torch.cuda.current_stream(self.device))
            self._produced[layer] = produced

    def flush(self) -> None:
        # land in-flight prefetches first: a pending page still owns a device
        # copy. A landed prefetch is clean by definition (update() targets
        # resident pages), so it retires without a writeback.
        for layer in sorted(self._pending):
            try:
                self._land(layer, self._take_pending(layer))
            except RuntimeError:
                pass  # upload failed: the host copy is still authoritative
        for layer in sorted(self._resident):
            self._retire(layer)
        if self._cuda:
            # the host copies may be read once their writebacks have landed
            self._wb_stream.synchronize()
            self._up_stream.synchronize()
            self._host_ready.clear()

    def close(self) -> None:
        self.flush()
