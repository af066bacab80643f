"""Invariant lint + contract layer of the port (own copies of the JAX
package's ``repro.analysis``).

* **Static analysis** (``python -m repro_torch.analysis --all``) — the
  checkers over ``src/repro_torch``: ``determinism`` (seeded-only
  randomness, torch's global generator included), ``dtypes`` (float64 /
  int64 on every pricing path), ``parity`` (every ``*_reference``
  registered with its fast path and a test), ``contracts`` (the CSR
  structures keep their validation hook), ``docs``
  (``docs/architecture_torch.md`` lists every public module) and
  ``tracelint`` (every pricing entry run under a recording dispatch
  mode: float64 outputs, every device→host read counted). Exemptions
  live in ``waivers.txt``, one reviewed reason per site.

* **Runtime contracts** (``repro_torch.analysis.contracts``) — the CSR
  invariants validated at construction when ``REPRO_VALIDATE=1``.

This ``__init__`` stays light on purpose: ``net`` imports
``repro_torch.analysis.contracts`` at module load, so nothing here may
pull in the AST machinery, the dispatch mode or ``repro_torch.net``.
"""

from repro_torch.analysis.contracts import (
    ContractViolation,
    maybe_validate,
    validation_enabled,
)

__all__ = [
    "ContractViolation",
    "maybe_validate",
    "validation_enabled",
]
