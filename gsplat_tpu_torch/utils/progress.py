"""Progress feedback for long multi-step loops: a tqdm bar on stderr when
tqdm is importable, else a plain counter; off when ``enabled`` is False or
on any rank but 0 of a ``torch.distributed`` job."""

from __future__ import annotations

import sys
from typing import Iterator, Sequence, TypeVar

from gsplat_tpu_torch.utils.logging import _rank

T = TypeVar("T")


def progress(items: Sequence[T], desc: str = "", enabled: bool = True) -> Iterator[T]:
    """Wrap an iterable with a progress bar; a plain pass-through when
    disabled."""
    if not enabled or _rank() != 0:
        yield from items
        return
    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = None
    if tqdm is not None:
        yield from tqdm(items, desc=desc, file=sys.stderr)
        return
    for i, item in enumerate(items):
        sys.stderr.write(f"\r{desc}: {i + 1}/{len(items)}")
        sys.stderr.flush()
        yield item
    sys.stderr.write("\n")
