"""graphdyn_torch — the graphdyn graph-dynamics framework on PyTorch and CUDA.

The port of the JAX package ``graphdyn`` (which stays in the repository as
the reference) to PyTorch on an NVIDIA H100. Module names follow the JAX
package, so each counterpart is found under the same name:

- ``graphdyn_torch.graphs``    — graph ensembles (RRG, Erdős–Rényi), the
  padded neighbor table and the distance-2 coloring, host numpy as in the
  reference.
- ``graphdyn_torch.ops``       — int8 synchronous dynamics (plain PyTorch);
  the 32-replicas-per-word packed rollout, whose step is a hand-written CUDA
  kernel (``csrc/packed_step.cu``) on the GPU; the update LUTs, the
  chromatic class step and the fused annealer chunk, one cooperative CUDA
  launch per chunk (``csrc/fused_anneal.cu``) on the GPU.
- ``graphdyn_torch.search``    — the fused SA annealer driver
  (``fused_anneal``), the chromatic sweeps (``chromatic_anneal``), the
  tempering ladder (``temper_search``) and the near-tie comparison against
  recorded runs.
- ``graphdyn_torch.observe``   — magnetization, consensus fraction.
- ``graphdyn_torch.models``    — the opinion-consensus m(0) sweep, the
  serial SA chain (``simulated_annealing``, ``sa_ensemble``), HPr and the
  BDCM entropy ladders.
- ``graphdyn_torch.parallel``  — meshes over ``torch.distributed`` ranks,
  node-axis sharding by a full gather or by the halo exchange (the
  packed-step kernel on the shard layout), and the sharded SA solver.
- ``graphdyn_torch.resilience`` — checkpoints, shutdown, supervision and
  the chaos soak.
- ``graphdyn_torch.interop``   — numpy bridges to the JAX package's arrays.

Entry points take ``device=`` and default to CUDA; without a CUDA device they
raise unless asked for ``device="cpu"``. The package never imports ``jax``
or ``graphdyn``.
"""

from graphdyn_torch.graphs import (  # noqa: F401
    Graph,
    random_regular_graph,
    erdos_renyi_graph,
    graph_from_edges,
)
from graphdyn_torch.ops.dynamics import (  # noqa: F401
    Rule,
    TieBreak,
    step_spins,
    run_dynamics,
    end_state,
)
from graphdyn_torch.observe import magnetization, consensus_fraction  # noqa: F401
from graphdyn_torch.config import DynamicsConfig, SAConfig, HPRConfig, EntropyConfig  # noqa: F401

__version__ = "0.1.0"
