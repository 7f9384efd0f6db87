"""rdfind_tpu_torch: CIND discovery in RDF on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``rdfind_tpu``, module for module under the same names.
It imports ``torch`` and never JAX, and nothing of ``rdfind_tpu``.  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``; with no device and no
card they raise.  On a CUDA tensor every kernel wrapper launches its hand-written
kernel (``csrc/``); on a CPU tensor it runs the kernel's plain PyTorch version.

Ported so far: strategy 0 (AllAtOnce) on one device, dense path.  What remains is
listed in ROADMAP.md.
"""

__version__ = "0.1.0"


def discover(triples, min_support: int = 10, strategy: int = 1, *,
             device=None, **kwargs):
    """One-call CIND discovery over an (N, 3) int32 id-triple table.

    ``strategy`` follows the reference's ids: 0 = all-at-once, 1 = small-to-large,
    2 = approximate all-at-once, 3 = late-BB.  Only 0 is ported; the others raise.
    Extra kwargs go to the strategy (``projections=``, ``stats=``,
    ``clean_implied=``, ...).  Returns a ``data.CindTable``.
    """
    from .runtime.driver import STRATEGIES

    fn = STRATEGIES.get(strategy)
    if fn is None:
        raise ValueError(f"traversal strategy {strategy} is not yet ported to "
                         f"the PyTorch/CUDA package (ported: "
                         f"{sorted(STRATEGIES)}); see ROADMAP.md")
    return fn(triples, min_support, device=device, **kwargs)
