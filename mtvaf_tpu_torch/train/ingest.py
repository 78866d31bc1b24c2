"""The frozen-ResNet guide cache of the trainer.

Counterpart of ``GuideCache`` in ``mtvaf_tpu/train/ingest.py``.  The
ResNet's stage guides are per-image constants: they are computed once on
the trainer's device, kept in a host LRU (spilling to ``.npz`` files on
eviction), and on bf16 runs also held in a device-resident bf16 table from
which batches are gathered on the card, so after the one-time row insert no
guide bytes cross to the device again.  Under data parallelism each rank
keeps its own cache and table, for the images of its own rows (the JAX
package's per-host table on its host-local submesh).

Every device operation here (the ResNet, the row inserts, the gathers) is
enqueued on the device's default stream by whichever thread calls
:meth:`GuideCache.batch`; the trainer's steps run on the same stream, so a
step is ordered after its batch's gather and a reused table row is
overwritten only after the gathers enqueued before it.  The JAX package's
power-of-two padding of a miss batch (which only avoided recompiles) and
its packed single-buffer upload are not ported: each host array is its own
pinned, non-blocking copy.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..core.platform import resolve_device, tree_to, upload
from ..nn.models import compute_visual_guides

logger = logging.getLogger(__name__)


class GuideCache:
    """Per-image cache of frozen-ResNet stage guides.

    * keyed per (image store, image id): each split resolves its aux crops
      through its own ``aux_map``/``aux_dir``;
    * host RAM holds at most ``max_items`` images (LRU, ~245 KB each at
      ResNet-152 widths); evicted entries spill to ``cache_dir``;
    * with ``device_items > 0`` a device-resident bf16 table holds one row
      per image (~123 KB at ResNet-152 widths), rows reused least recently
      used first; a batch whose images are all resident comes back as
      device tensors gathered from it;
    * ``compute_s`` and ``computed`` count the ResNet's wall time (host
      clock, synchronised by the copy back) and images.
    """

    def __init__(self, resnet_params, depth: int, *, max_items: int = 8192,
                 cache_dir: Optional[str] = None, device_items: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.resnet_params = tree_to(resnet_params, self.device)
        self.depth = depth
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.max_items = max(int(max_items), 1)
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self.device_items = int(device_items)
        self._dev_main = None          # (N, 4, C) bf16
        self._dev_aux = None           # (N, A, 4, C) bf16
        self._dev_rows: "OrderedDict[tuple, int]" = OrderedDict()
        self._table_full_warned = False
        self.compute_s = 0.0
        self.computed = 0

    # -- host LRU and disk spill ------------------------------------------

    @staticmethod
    def _store_key(store) -> str:
        return f"{store.img_dir}|{store.aux_dir}"

    def _disk_path(self, key: tuple) -> Optional[str]:
        if not self.cache_dir:
            return None
        h = hashlib.md5("|".join(key).encode()).hexdigest()
        return os.path.join(self.cache_dir, h + ".npz")

    def _put(self, key: tuple, value: tuple, *, spill: bool = True):
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.max_items:
            old_key, old_val = self._cache.popitem(last=False)
            path = self._disk_path(old_key)
            if spill and path and not os.path.exists(path):
                # data-parallel ranks share the directory: a reader sees a
                # whole file or none
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    np.savez(f, main=old_val[0], aux=old_val[1])
                os.replace(tmp, path)

    def _get(self, key: tuple):
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        path = self._disk_path(key)
        if path and os.path.exists(path):
            with np.load(path) as z:
                value = (z["main"], z["aux"])
            self._put(key, value, spill=False)
            return value
        return None

    def _compute(self, main: np.ndarray, aux: np.ndarray):
        """ResNet guides of host pixel rows, back on the host as fp32."""
        t0 = time.perf_counter()
        with torch.no_grad():
            mg, ag = compute_visual_guides(
                self.resnet_params, upload(main, self.device),
                upload(aux, self.device), depth=self.depth)
            mg, ag = mg.float().cpu().numpy(), ag.float().cpu().numpy()
        self.compute_s += time.perf_counter() - t0
        self.computed += len(main)
        return mg, ag

    def _fill(self, keys, store) -> dict:
        """Every key's guides, computing the misses in one ResNet call.
        This call's values are held locally, so an LRU eviction inside the
        batch cannot drop one it needs."""
        local = {}
        for k in dict.fromkeys(keys):
            v = self._get(k)
            if v is not None:
                local[k] = v
        missing = [k for k in dict.fromkeys(keys) if k not in local]
        if missing:
            main, aux = store.batch([k[1] for k in missing])
            mg, ag = self._compute(main, aux)
            for j, k in enumerate(missing):
                local[k] = (mg[j], ag[j])
                self._put(k, local[k])
        return local

    # -- the device table ---------------------------------------------------

    def _insert_rows(self, keys, local) -> bool:
        """Give every key a table row (one upload for the batch's new
        rows); False when the batch has more images than the table."""
        unique = list(dict.fromkeys(keys))
        if len(unique) > self.device_items:
            return False
        for k in unique:
            if k in self._dev_rows:
                self._dev_rows.move_to_end(k)
        new = [k for k in unique if k not in self._dev_rows]
        if not new:
            return True
        rows = []
        for k in new:
            if len(self._dev_rows) >= self.device_items:
                _, row = self._dev_rows.popitem(last=False)
                if not self._table_full_warned:
                    self._table_full_warned = True
                    logger.warning(
                        "device guide table full (%d rows): reusing the "
                        "least recently used rows; raise "
                        "--guide_cache_device_items if the working set "
                        "exceeds the table", self.device_items)
            else:
                row = len(self._dev_rows)
            self._dev_rows[k] = row
            rows.append(row)
        main = np.stack([local[k][0] for k in new])
        aux = np.stack([local[k][1] for k in new])
        if self._dev_main is None:
            self._dev_main = torch.zeros(
                (self.device_items,) + main.shape[1:], dtype=torch.bfloat16,
                device=self.device)
            self._dev_aux = torch.zeros(
                (self.device_items,) + aux.shape[1:], dtype=torch.bfloat16,
                device=self.device)
        idx = upload(np.asarray(rows, np.int64), self.device)
        self._dev_main.index_copy_(
            0, idx, upload(main, self.device).to(torch.bfloat16))
        self._dev_aux.index_copy_(
            0, idx, upload(aux, self.device).to(torch.bfloat16))
        return True

    def batch(self, image_ids, store, accum: int = 1):
        """Guides for a batch of image ids: (main, aux).

        Device bf16 tensors gathered from the table, shaped
        ``(accum, B/accum, ...)`` when ``accum > 1``, when the table is on
        and holds the batch; host fp32 arrays ``(B, ...)`` otherwise."""
        skey = self._store_key(store)
        keys = [(skey, i) for i in image_ids]
        local = self._fill(keys, store)
        if self.device_items > 0 and self._insert_rows(keys, local):
            idx = upload(np.asarray([self._dev_rows[k] for k in keys],
                                    np.int64), self.device)
            main = self._dev_main.index_select(0, idx)
            aux = self._dev_aux.index_select(0, idx)
            if accum > 1:
                main = main.reshape(accum, -1, *main.shape[1:])
                aux = aux.reshape(accum, -1, *aux.shape[1:])
            return main, aux
        return (np.stack([local[k][0] for k in keys]),
                np.stack([local[k][1] for k in keys]))
