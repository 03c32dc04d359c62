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
    collectives.counter.widths()     # {"all_reduce/data": 4, ...}

``widths()`` is the widest process group each ``kind/axis`` ran on (an
axis's group, the joined axes' group, or the host group over the whole
world): a serving replica's collectives must stay within its group, and
the contract cell ``replica_2x2`` (:mod:`repro_torch.lint.contracts`)
reads it, the port's counterpart of the group sizes the JAX package
parses from a compiled program's replica groups.
"""
from __future__ import annotations

from typing import Dict


class CollectiveCounter:
    """Calls and their payload bytes by ``kind/axis``."""

    def __init__(self):
        self._calls: Dict[str, int] = {}
        self._bytes: Dict[str, int] = {}
        self._widths: Dict[str, int] = {}

    def add(self, kind: str, axis: str, nbytes: int, width: int = 1) -> None:
        """One call of ``kind`` on ``axis``'s group of ``width`` ranks,
        handed ``nbytes``."""
        key = f"{kind}/{axis}"
        self._calls[key] = self._calls.get(key, 0) + 1
        self._bytes[key] = self._bytes.get(key, 0) + nbytes
        self._widths[key] = max(self._widths.get(key, 0), width)

    def reset(self) -> None:
        self._calls.clear()
        self._bytes.clear()
        self._widths.clear()

    def snapshot(self) -> Dict[str, int]:
        return dict(self._calls)

    def payload(self) -> Dict[str, int]:
        return dict(self._bytes)

    def widths(self) -> Dict[str, int]:
        """The widest group, in ranks, that each ``kind/axis`` ran on."""
        return dict(self._widths)


counter = CollectiveCounter()
