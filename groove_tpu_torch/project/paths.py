"""Asset search paths.

The reference's `groove-utils::Paths` searches multiple roots (hive / user /
cwd) for assets like `patches/welsh/<name>.json` and `samples/...`
(settings/src/instruments.rs:42-46, src/bin/groove-egui.rs:237-243).

Here: an ordered list of root directories, searched first-hit. Default
roots: $GROOVE_ASSETS (if set) and the CWD. (groove_tpu's copy of this
module also searches a fixed location of the reference asset tree, for
its golden tests; this package takes its assets from $GROOVE_ASSETS or an
explicit root list only.)
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Optional


class Paths:
    def __init__(self, roots: Optional[Iterable[os.PathLike | str]] = None):
        if roots is None:
            roots = []
            env = os.environ.get("GROOVE_ASSETS")
            if env:
                roots.append(env)
            roots.append(Path.cwd())
        self.roots = [Path(r) for r in roots]

    def search(self, relative: os.PathLike | str) -> Optional[Path]:
        rel = Path(relative)
        if rel.is_absolute() and rel.exists():
            return rel
        for root in self.roots:
            cand = root / rel
            if cand.exists():
                return cand
        return None

    def build_patch(self, kind: str, name: str) -> Path:
        return Path("patches") / kind / name

    def build_sample(self, relative: os.PathLike | str) -> Path:
        return Path("samples") / relative
