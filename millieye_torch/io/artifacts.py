"""Tracked fallbacks for checkpoints (port of
``millieye_tpu/io/artifacts.py``).

``runs/`` is gitignored, so a clean checkout has none; stage-final
checkpoints are mirrored into the tracked ``artifacts/`` directory, and
entry points resolve their checkpoint argument through
``resolve_checkpoint``: a fresh ``runs/`` copy wins when present, the
tracked mirror keeps a clean checkout runnable.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO_ROOT, "artifacts")


def resolve_checkpoint(path):
    """``path`` if it exists, else its ``artifacts/`` mirror.

    The mirror stands in only for the default ``runs/synthetic/``
    checkpoints, and says so when it does: a missing experiment path (a
    mistyped ``runs/exp_ablation/stage3_final.npz``) raises rather than
    scoring the mirror under the wrong name. Raises FileNotFoundError
    naming both candidates, and the command that regenerates them, when
    neither exists."""
    if os.path.exists(path):
        return path
    alt = os.path.join(ARTIFACTS, os.path.basename(path))
    default_dir = os.path.join("runs", "synthetic")
    is_default = os.path.normpath(os.path.dirname(path)).endswith(default_dir)
    if is_default and os.path.exists(alt):
        print(f"[artifacts] checkpoint {path} missing — "
              f"using tracked mirror {alt}", flush=True)
        return alt
    if not is_default:
        raise FileNotFoundError(
            f"checkpoint not found: {path} (non-default path — the "
            f"artifacts/ mirror fallback only applies to {default_dir}/)")
    raise FileNotFoundError(
        f"checkpoint not found: {path} (no tracked mirror {alt} either) "
        "— regenerate with `python benchmarks/synthetic_e2e.py`")


def mirror_checkpoint(path):
    """Copy a checkpoint into ``artifacts/``; returns the mirror's path."""
    import shutil
    os.makedirs(ARTIFACTS, exist_ok=True)
    dst = os.path.join(ARTIFACTS, os.path.basename(path))
    shutil.copy2(path, dst)
    return dst
