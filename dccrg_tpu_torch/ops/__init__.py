"""Device kernels: hand-written CUDA with plain PyTorch twins.

Every kernel wrapper adds one to :data:`LAUNCHES` under its name where it
launches its kernel, and nowhere else; every twin adds one to
:data:`PLAIN_CALLS`.  ``reset_counts`` sets them all to 0.
"""

#: kernel launches per wrapper (CUDA tensors only)
LAUNCHES = {"fused_run": 0, "flux_update_blocked": 0, "flux_update": 0,
            "flat_amr_run": 0, "flat_ml_run": 0, "gol_run": 0,
            "vlasov_step": 0, "bicg_solve": 0, "ring_copy": 0}
#: plain-twin calls per wrapper
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def nonzero(counts: dict) -> dict:
    """The entries of a count table that are not 0."""
    return {k: v for k, v in counts.items() if v}
