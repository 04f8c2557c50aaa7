"""Configuration for the out-of-core streaming screener.

One knob object threads through the subsystem.  The memory model it
controls:

    peak screening bytes  ~=  pair_batch * tile^2 * itemsize   (in-flight tiles)
                            + 3 * 8 * #edges                   (compacted edges)
                            + O(n * p)                         (X on the device)

so ``memory_budget_mb`` simply solves for ``pair_batch``.  The dense (p, p)
covariance never exists; ``stream.bytes_peak`` (instrument watermark)
records what did.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

#: covgram_screen dispatch: "auto" = the CUDA kernel on a CUDA device and
#: the plain version on the CPU; "pallas" = the kernel (raises without a
#: CUDA device — the reference's name for its kernel); "ref" = the plain
#: version on whatever device the screen runs on
BACKENDS = ("auto", "pallas", "ref")


@dataclass(frozen=True)
class StreamConfig:
    """Knobs for one streaming screen.

    tile           column-tile width (the covgram_screen block_p); need not
                   divide p — the last tile is padded and masked.
    chunk          row-chunk height of the moments pass, and the multiple
                   the rows of X are padded to for the kernel.
    pair_batch     tile PAIRS computed in flight per kernel call; the
                   dominant peak-memory term.  Derived from
                   ``memory_budget_mb`` when that is set.
    memory_budget_mb  optional cap on the in-flight tile batch; overrides
                   pair_batch.
    backend        one of ``BACKENDS``.
    skip_slack     relative inflation of the Cauchy-Schwarz tile-skip bound
                   sqrt(max_I S_ii * max_J S_jj) <= lam: the Gram's
                   floating-point sum can overshoot the exact bound by a few
                   ulps, so the skip test uses bound * (1 + skip_slack) <= lam.
    """

    tile: int = 512
    chunk: int = 512
    pair_batch: int = 64
    memory_budget_mb: float | None = None
    backend: str = "auto"
    skip_slack: float = 1e-6

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown covgram_screen backend {self.backend!r}; available: {BACKENDS}"
            )

    def resolved_pair_batch(self, itemsize: int) -> int:
        """Tile pairs per kernel call; ``itemsize`` is the real element size
        of the tiles (8: the screen promotes X to float64)."""
        if self.memory_budget_mb is None:
            return max(1, int(self.pair_batch))
        budget = self.memory_budget_mb * 2**20
        per_pair = self.tile * self.tile * itemsize
        return max(1, int(budget // max(per_pair, 1)))


def as_config(config) -> StreamConfig:
    """None -> defaults; dict -> kwargs; StreamConfig passes through; another
    dataclass with the same fields (the reference package's StreamConfig)
    converts field by field."""
    if config is None:
        return StreamConfig()
    if isinstance(config, StreamConfig):
        return config
    if isinstance(config, dict):
        return StreamConfig(**config)
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return StreamConfig(**dataclasses.asdict(config))
    raise TypeError(f"expected StreamConfig, dict, or None; got {type(config)!r}")
