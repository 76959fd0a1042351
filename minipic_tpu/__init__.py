"""tpu-minipic: a 2-D particle-in-cell engine in JAX, run on NVIDIA GPUs.

A from-scratch re-design of the capabilities of the reference Mini-PIC
(C++/MPI 2-D Yee FDTD field solver with tiling + guard-cell exchange +
dynamic tile load balance + HDF5 snapshots), completed to the full PIC
loop the reference designed toward: dense shape-vector gather/deposition
over fixed-capacity particle tiles (a fused Triton kernel on the GPU,
batched products in XLA elsewhere), shard_map + ppermute domain
decomposition, sort-based device-side load balancing.  See SURVEY.md at
the repo root for the full design map.
"""

from .core.config import Deck, SpeciesSpec
from .core.geometry import Domain, Tiling
from .core.state import CurrentState, FieldState, ParticleState, SimState
from .simulation import Simulation, StepDiag, build_step

__all__ = [
    "Deck",
    "SpeciesSpec",
    "Domain",
    "Tiling",
    "FieldState",
    "CurrentState",
    "ParticleState",
    "SimState",
    "Simulation",
    "StepDiag",
    "build_step",
]

__version__ = "0.1.0"
