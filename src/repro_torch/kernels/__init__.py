"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the dispatch layer (``ops``).

``LAUNCHES`` counts, per kernel, the launches its wrapper made on the card
(a CPU tensor takes the plain version and counts nothing), so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0,
                            "moe_gmm": 0, "rwkv6_scan": 0, "mamba_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)
