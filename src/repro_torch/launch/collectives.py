"""What the data-parallel step hands its collectives: the count of calls by
kind and mesh axis, and the payload of each (the bytes of the buffer this
rank gives the call, ``numel * element_size``), bumped by the mesh's
wrappers (:class:`repro_torch.launch.mesh.DPMesh`) where the calls are
made.  A pickled object is not sized: a broadcast of one and a barrier
count as calls of 0 bytes.

The payloads are not the bytes on the wire: what a collective sends over
its links depends on its algorithm and group, and
:func:`repro_torch.roofline.dp_wire_stages` derives it from the payloads
:func:`repro_torch.roofline.dp_payloads` predicts.  A step that hands its
collectives more than that prediction, or makes one collective a leaf,
reads off this counter.  It is the port's counterpart of the JAX
package's ``roofline.hlo.collectives_report`` for this step, counted at
the call, not parsed from a compiled program.

    from repro_torch.launch import collectives
    collectives.counter.reset()
    step(...)
    collectives.counter.snapshot()   # {"all_reduce/data": 1, ...}
    collectives.counter.payload()    # {"all_reduce/data": 8 + 4 * n, ...}
"""
from __future__ import annotations

from typing import Dict


class CollectiveCounter:
    """Calls and their payload bytes by ``kind/axis``."""

    def __init__(self):
        self._calls: Dict[str, int] = {}
        self._bytes: Dict[str, int] = {}

    def add(self, kind: str, axis: str, nbytes: int) -> None:
        key = f"{kind}/{axis}"
        self._calls[key] = self._calls.get(key, 0) + 1
        self._bytes[key] = self._bytes.get(key, 0) + nbytes

    def reset(self) -> None:
        self._calls.clear()
        self._bytes.clear()

    def snapshot(self) -> Dict[str, int]:
        return dict(self._calls)

    def payload(self) -> Dict[str, int]:
        return dict(self._bytes)


counter = CollectiveCounter()
