"""graphdyn_torch.analysis — static analysis, contracts and race checking
for the port (the port of ``graphdyn/analysis/``: the same module names,
rule codes, CLI shapes and exit codes).

- :mod:`~graphdyn_torch.analysis.contracts` — ``@contract``, the shape and
  dtype checks on the port's entry points, from tensor metadata only.
- :mod:`~graphdyn_torch.analysis.graftlint` — the AST linter with the
  port's counterparts of GD001–GD017 and its own rules; ``python -m
  graphdyn_torch.analysis graphdyn_torch/`` (exit code = findings).
- :mod:`~graphdyn_torch.analysis.sanitize` — the host-aliasing sanitizer
  (``GRAPHDYN_SANITIZE=alias``) over ``torch.from_numpy``,
  ``torch.as_tensor`` and pinned ``non_blocking`` copies.
- :mod:`~graphdyn_torch.analysis.racecheck` — the host-concurrency auditor
  over the committed ``concurrency_ledger.json`` and the runtime lock proxy
  (``GRAPHDYN_RACECHECK=1``, ``GRAPHDYN_RACEFUZZ``). Not imported here.
- :mod:`~graphdyn_torch.analysis.graftcheck` — dispatch fingerprints of the
  entry points' chunks against ``fingerprints.json``. Not imported here.
- :mod:`~graphdyn_torch.analysis.graftcost` — resident-peak models fitted
  from the card's allocator against ``cost_ledger.json``, and the hand byte
  models held to them. Not imported here.
"""

from graphdyn_torch.analysis.contracts import ContractError, contract  # noqa: F401
from graphdyn_torch.analysis.sanitize import (  # noqa: F401
    AliasRaceError,
    alias_sanitizer,
    maybe_alias_sanitizer,
)
from graphdyn_torch.analysis.graftlint import (  # noqa: F401
    Finding,
    RULES,
    lint_paths,
    lint_sources,
    main,
)
