"""npy/npz tensor comparison.

Counterpart of ``animsnapbases_tpu/analysis/compare.py``: compares two
stored arrays (optionally up to a per-component sign, since SVD-based
bases are sign-ambiguous) and reports the max and mean absolute
difference.  ``python -m animsnapbases_tpu_torch.analysis.compare A B``.
"""

from __future__ import annotations

import numpy as np


def compare_npy_files(path_a: str, path_b: str, key: str | None = None,
                      rtol: float = 0.0, atol: float = 1e-5,
                      sign_invariant: bool = False) -> dict:
    """Returns {"equal": bool, "max_abs": float, "mean_abs": float}."""
    a = _load(path_a, key)
    b = _load(path_b, key)
    if a.shape != b.shape:
        return {"equal": False, "max_abs": float("inf"),
                "mean_abs": float("inf"),
                "shapes": (a.shape, b.shape)}
    if sign_invariant and a.ndim >= 2:
        # align the sign of each leading-axis slice
        flat_a = a.reshape(a.shape[0], -1)
        flat_b = b.reshape(b.shape[0], -1)
        signs = np.sign((flat_a * flat_b).sum(axis=1))
        signs[signs == 0] = 1.0
        a = (flat_a * signs[:, None]).reshape(a.shape)
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    return {"equal": bool((diff <= tol).all()),
            "max_abs": float(diff.max()),
            "mean_abs": float(diff.mean())}


def _load(path: str, key: str | None):
    data = np.load(path, allow_pickle=True)
    if hasattr(data, "files"):
        if key is None:
            key = data.files[0]
        data = data[key]
    return np.asarray(data, dtype=float)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Compare two .npy/.npz tensors")
    ap.add_argument("file_a")
    ap.add_argument("file_b")
    ap.add_argument("--key", default=None)
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--sign-invariant", action="store_true")
    args = ap.parse_args(argv)
    out = compare_npy_files(args.file_a, args.file_b, key=args.key,
                            atol=args.atol,
                            sign_invariant=args.sign_invariant)
    print(out)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
