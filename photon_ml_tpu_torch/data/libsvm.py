"""LIBSVM text ingest (a copy of photon_ml_tpu/data/libsvm.py:1-68;
reference: ml/io/LibSVMInputDataFormat.scala:1-78).

Produces host-side CSR + labels; intercept appended as a trailing constant-1
column when requested (the reference's addIntercept, GLMSuite semantics).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def read_libsvm(
    path: str | Path,
    num_features: Optional[int] = None,
    add_intercept: bool = True,
    zero_based: bool = False,
    map_negative_labels: bool = True,
) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Returns (features CSR [n, d(+1)], labels f64[n]).

    With ``map_negative_labels`` (default), labels -1/+1 are mapped to 0/1 —
    the binary-classification convention of the reference's readers. Pass
    False for regression/Poisson tasks where -1 is a legitimate target.
    Malformed lines raise with the line number.
    """
    labels = []
    data, indices, indptr = [], [], [0]
    max_idx = -1
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            try:
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    idx_s, val_s = tok.split(":", 1)
                    idx = int(idx_s) - (0 if zero_based else 1)
                    if idx < 0:
                        raise ValueError(f"feature index {idx_s} out of range")
                    indices.append(idx)
                    data.append(float(val_s))
                    max_idx = max(max_idx, idx)
            except (ValueError, IndexError) as e:
                raise ValueError(f"{path}:{lineno}: malformed line: {e}") from e
            indptr.append(len(indices))

    n = len(labels)
    d = num_features if num_features is not None else max_idx + 1
    if max_idx >= d:
        raise ValueError(
            f"feature index {max_idx} >= declared num_features {d}")
    mat = sp.csr_matrix(
        (np.asarray(data), np.asarray(indices, np.int64),
         np.asarray(indptr, np.int64)),
        shape=(n, d))
    if add_intercept:
        mat = sp.hstack(
            [mat, np.ones((n, 1))], format="csr")
    y = np.asarray(labels, np.float64)
    if map_negative_labels:
        y[y == -1] = 0.0
    return mat, y
