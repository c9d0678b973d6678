"""Columnar pod mirror — the cache's dense half.

The TPU encoder needs the scheduler-relevant pod fields (requests, priority,
creation time, predicate signature, trait flags) as dense arrays every
session. Extracting them from 50k Python objects costs ~100+ ms per cycle;
this table maintains them *incrementally* as the cache's event handlers
add/update/delete tasks, so encoding becomes a handful of numpy gathers.
It is the same architectural move the k8s scheduler's equivalence classes
and the reference's per-template predicate sharing gesture at
(predicates.go:281-299), taken to its TPU-native conclusion: the cluster
mirror IS the device-feed.

Concurrency: rows are assigned/freed under the table's own lock by the
cache handlers; every (re)assignment bumps the row's generation. A reader
(the encoder, which runs outside the cache lock) gathers under the table
lock and validates that each TaskInfo's recorded (row, generation) still
matches — a freed/reused row fails the check and the caller falls back to
the object walk, so stale data can never be encoded.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from volcano_tpu_torch.api import objects
from volcano_tpu_torch.api.pod_traits import pod_encode_traits

FLAG_PORTS = np.uint8(1)
FLAG_AFFINITY = np.uint8(2)
FLAG_REQ_EMPTY = np.uint8(4)
# references a PersistentVolumeClaim: volume assume/bind (StoreVolumeBinder)
# is live per-host logic the bulk solve does not model -> serial residue
FLAG_PVC = np.uint8(8)


class PodTable:
    _GROW = 1024

    def __init__(self):
        self.lock = threading.Lock()
        cap = self._GROW
        self._cap = cap
        self.cpu = np.zeros(cap, np.float64)
        self.mem = np.zeros(cap, np.float64)
        self.init_cpu = np.zeros(cap, np.float64)
        self.init_mem = np.zeros(cap, np.float64)
        self.priority = np.zeros(cap, np.int64)
        self.ctime = np.zeros(cap, np.float64)
        self.flags = np.zeros(cap, np.uint8)
        self.sig_id = np.zeros(cap, np.int32)
        self.gen = np.zeros(cap, np.int64)
        # uid per row as a ready-made object column: the encoder's task
        # ordering tie-breaks on uid, and building a 50k-string numpy array
        # from Python objects every session costs more than the lexsort
        # itself — here it is maintained incrementally like every column
        self.uid = np.empty(cap, object)
        self.scalar_cols: Dict[str, np.ndarray] = {}       # resreq scalars
        self.init_scalar_cols: Dict[str, np.ndarray] = {}  # init_resreq
        self._scalar_refs: Dict[str, int] = {}  # live rows using the scalar
        self.sig_keys: List[str] = []           # sig id -> key
        self._sig_ids: Dict[str, int] = {}
        self._uid_row: Dict[str, int] = {}
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._gen_counter = 0

    # -- maintenance (cache handlers) --------------------------------------

    def _grow(self) -> None:
        old = self._cap
        new = old + max(old, self._GROW)
        for name in ("cpu", "mem", "init_cpu", "init_mem", "priority",
                     "ctime", "flags", "sig_id", "gen"):
            arr = getattr(self, name)
            grown = np.zeros(new, arr.dtype)
            grown[:old] = arr
            setattr(self, name, grown)
        uid_grown = np.empty(new, object)
        uid_grown[:old] = self.uid
        self.uid = uid_grown
        for cols in (self.scalar_cols, self.init_scalar_cols):
            for rn, col in cols.items():
                grown = np.zeros(new, col.dtype)
                grown[:old] = col
                cols[rn] = grown
        self._free.extend(range(new - 1, old - 1, -1))
        self._cap = new

    def add(self, pod: objects.Pod, task) -> None:
        """Assign (or reassign) a row for `task` (which wraps `pod`) and
        record it on the TaskInfo as (row, row_gen)."""
        with self.lock:
            old = self._uid_row.pop(task.uid, None)
            if old is not None:
                self._release_row(old)
            if not self._free:
                self._grow()
            row = self._free.pop()
            self._gen_counter += 1
            self.gen[row] = self._gen_counter

            req = task.resreq
            init = task.init_resreq
            self.cpu[row] = req.milli_cpu
            self.mem[row] = req.memory
            self.init_cpu[row] = init.milli_cpu
            self.init_mem[row] = init.memory
            self.priority[row] = task.priority
            self.ctime[row] = pod.metadata.creation_timestamp
            key, ports, aff = pod_encode_traits(pod)
            flags = np.uint8(0)
            if ports:
                flags |= FLAG_PORTS
            if aff:
                flags |= FLAG_AFFINITY
            if req.is_empty():
                flags |= FLAG_REQ_EMPTY
            if any(v.persistent_volume_claim for v in pod.spec.volumes):
                flags |= FLAG_PVC
            self.flags[row] = flags
            sid = self._sig_ids.get(key)
            if sid is None:
                sid = self._sig_ids[key] = len(self.sig_keys)
                self.sig_keys.append(key)
            self.sig_id[row] = sid

            for rn, v in (req.scalar_resources or {}).items():
                self._set_scalar(self.scalar_cols, row, rn, v)
            for rn, v in (init.scalar_resources or {}).items():
                self._set_scalar(self.init_scalar_cols, row, rn, v)

            self._uid_row[task.uid] = row
            self.uid[row] = task.uid
            task.row = row
            task.row_gen = self._gen_counter

    def _set_scalar(self, cols: Dict[str, np.ndarray], row: int, rn: str,
                    value: float) -> None:
        col = cols.get(rn)
        if col is None:
            col = cols[rn] = np.zeros(self._cap, np.float64)
        if value:
            self._scalar_refs[rn] = self._scalar_refs.get(rn, 0) + 1
        col[row] = value

    def remove(self, uid: str) -> None:
        with self.lock:
            row = self._uid_row.pop(uid, None)
            if row is not None:
                self._release_row(row)

    def _release_row(self, row: int) -> None:
        self._gen_counter += 1
        self.gen[row] = self._gen_counter  # readers holding old gen fail
        self.uid[row] = None  # don't pin the uid string until row reuse
        for cols in (self.scalar_cols, self.init_scalar_cols):
            for rn, col in cols.items():
                if col[row]:
                    self._scalar_refs[rn] -= 1
                    col[row] = 0.0
        self._free.append(row)

    # -- reading (encoder) -------------------------------------------------

    def scalar_names(self) -> List[str]:
        """Scalars referenced by any live row (may over-include rows whose
        scalar value was 0 — harmless: an extra all-zero resource dim)."""
        with self.lock:
            return [rn for rn, c in self._scalar_refs.items() if c > 0]

    def gather(self, rows: np.ndarray, gens: np.ndarray,
               scalar_names: List[str]) -> Optional[dict]:
        """Validated snapshot of the given rows, or None when ANY row's
        generation no longer matches (caller falls back to the object
        walk). Runs under the table lock so rows cannot be reused
        mid-gather."""
        with self.lock:
            if rows.size and (rows.min() < 0 or rows.max() >= self._cap):
                return None
            if not np.array_equal(self.gen[rows], gens):
                return None
            out = {
                "uid": self.uid[rows],
                "cpu": self.cpu[rows],
                "mem": self.mem[rows],
                "init_cpu": self.init_cpu[rows],
                "init_mem": self.init_mem[rows],
                "priority": self.priority[rows],
                "ctime": self.ctime[rows],
                "flags": self.flags[rows],
                "sig_id": self.sig_id[rows],
                "scalars": {},
                "init_scalars": {},
            }
            zeros = None
            for rn in scalar_names:
                for key, cols in (("scalars", self.scalar_cols),
                                  ("init_scalars", self.init_scalar_cols)):
                    col = cols.get(rn)
                    if col is None:
                        if zeros is None:
                            zeros = np.zeros(rows.size, np.float64)
                        out[key][rn] = zeros
                    else:
                        out[key][rn] = col[rows]
            return out
