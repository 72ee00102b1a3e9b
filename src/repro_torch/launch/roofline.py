"""Roofline terms of one step on one NVIDIA H100 SXM (the port's
counterpart of ``repro.launch.roofline``'s :class:`Roofline` term algebra).

Three terms per (arch x shape x workers), in seconds, from the H100 SXM
data sheet (dense rates, at the card's 700 W limit):

    compute    = flops / PEAK_FLOPS               (989 TFLOP/s bf16)
    memory     = hbm_bytes / HBM_BW               (3.35 TB/s HBM3)
    collective = coll_bytes / (LINK_BW x LINKS)   (NVLink 4: 18 links x 25 GB/s
                                                   per direction)

The reference also parses XLA's optimized HLO text for the collective
bytes (``hlo_collective_bytes``) and reads a compiled artifact's cost
analysis (``extract``).  Both are XLA's and have no port: the port books
its collectives through ``core/comms.py`` and compiles no program, so
``coll_bytes_hlo`` stays 0 here.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12  # bf16 dense, per card
HBM_BW = 3.35e12  # B/s per card
LINK_BW = 25e9  # B/s per NVLink 4 link and direction
LINKS = 18  # NVLink 4 links per card


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float  # per device
    hbm_bytes: float
    coll_bytes: float  # per device, booked
    coll_bytes_hlo: float  # the reference's HLO cross-check; 0 in the port
    coll_by_kind: dict
    backward_factor: float = 1.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes * self.backward_factor / (LINK_BW * LINKS)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_bytes_hlo": self.coll_bytes_hlo,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_by_kind": self.coll_by_kind,
        }
