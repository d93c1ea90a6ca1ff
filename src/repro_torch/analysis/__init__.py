"""The port's static-analysis gate (``docs/analysis_torch.md``): the
counterpart of the reference's ``repro.analysis``.

* ``census`` + ``audit``: program contracts (dtypes, host reads,
  collectives, kernel launches, float divisions, float64 bytes) taken from
  the op stream of each production entry point and diffed against the
  committed ``AUDIT_torch_contracts.json``.
* ``lint``: the port's AST lint rules (stdlib only).

Nothing here imports the JAX package; ``lint`` does not import torch.
"""
