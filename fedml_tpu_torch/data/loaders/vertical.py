"""Vertically-partitioned (feature-split) datasets for VFL (port of
``fedml_tpu/data/loaders/vertical.py``).

Reference: NUS-WIDE two/three-party split (NUS_WIDE/nus_wide_dataset.py:73 —
party A gets 634 low-level image features, party B the 1000-d bag-of-tags;
binary one-vs-rest label from the top-5 concepts) and lending_club loan
(lending_club_loan/lending_club_dataset.py:100 — pandas featurisation, the
loan-status binary label, features split across two parties).

Real CSVs are download-gated; ``vertical_split`` turns ANY (x, y) into an
n-party feature split, and the two loaders below read the real files when
present or synthesize matching shapes otherwise.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def vertical_split(
    x: np.ndarray, splits: Sequence[int]
) -> List[np.ndarray]:
    """Split features [n, d] into parties of widths ``splits`` (sum ≤ d;
    remainder goes to the last party)."""
    parts, pos = [], 0
    for i, w in enumerate(splits):
        end = x.shape[1] if i == len(splits) - 1 and sum(splits) >= x.shape[1] else pos + w
        parts.append(x[:, pos:end])
        pos = end
    return parts


def _synth_binary(n: int, d: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    w = rng.randn(d)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n) > 0).astype(np.float32)
    return x, y


def load_two_party_nus_wide(
    data_dir: str | None = None,
    selected_label: str = "sky",
    n_samples: int = 2000,
    seed: int = 0,
):
    """Two-party NUS-WIDE: returns (Xa_train, Xb_train, y_train),
    (Xa_test, Xb_test, y_test). Party A: 634 image features; party B: 1000
    tag features (NUS_WIDE_load_two_party_data, nus_wide_dataset.py:73-120)."""
    d_a, d_b = 634, 1000
    if data_dir and os.path.isdir(data_dir):
        # Real layout: Low_Level_Features/*.dat + NUS_WID_Tags/*.dat + labels.
        # Parsing mirrors get_labeled_data_with_2_party semantics via pandas.
        import pandas as pd

        feat_dir = os.path.join(data_dir, "Low_Level_Features")
        dfs = [
            pd.read_csv(os.path.join(feat_dir, f), sep=" ", header=None)
            for f in sorted(os.listdir(feat_dir))
            if f.startswith("Train")
        ]
        xa = pd.concat(dfs, axis=1).dropna(axis=1).values.astype(np.float32)
        tags = pd.read_csv(
            os.path.join(data_dir, "NUS_WID_Tags", "Train_Tags1k.dat"),
            sep="\t",
            header=None,
        ).values.astype(np.float32)
        lab = pd.read_csv(
            os.path.join(
                data_dir, "Groundtruth", "TrainTestLabels",
                f"Labels_{selected_label}_Train.txt",
            ),
            header=None,
        ).values.ravel()
        n = min(len(xa), len(tags), len(lab), n_samples if n_samples > 0 else len(xa))
        xa, xb, y = xa[:n], tags[:n], (lab[:n] > 0).astype(np.float32)
    else:
        x, y = _synth_binary(n_samples, d_a + d_b, seed)
        xa, xb = vertical_split(x, [d_a, d_b])
    k = int(0.8 * len(y))
    return (xa[:k], xb[:k], y[:k]), (xa[k:], xb[k:], y[k:])


def load_three_party_nus_wide(
    data_dir: str | None = None, n_samples: int = 2000, seed: int = 0
):
    """Three-party variant: B's tag features are themselves split in half
    (NUS_WIDE_load_three_party_data, nus_wide_dataset.py:122-164)."""
    (xa, xb, y), (xa_t, xb_t, y_t) = load_two_party_nus_wide(
        data_dir, n_samples=n_samples, seed=seed
    )
    half = xb.shape[1] // 2
    return (
        (xa, xb[:, :half], xb[:, half:], y),
        (xa_t, xb_t[:, :half], xb_t[:, half:], y_t),
    )


LOAN_FEATURE_SPLITS = (20, 18)  # guest/host widths after featurisation


def load_lending_club(
    data_path: str | None = None, n_samples: int = 2000, seed: int = 1
):
    """lending_club loan: binary good/bad-loan label, numeric features split
    between two parties (lending_club_dataset.py:100-140 prepare_data/
    process_data — digitize categorical cols, normalize, split)."""
    d = sum(LOAN_FEATURE_SPLITS)
    if data_path and os.path.isfile(data_path):
        import pandas as pd

        df = pd.read_csv(data_path, low_memory=False)
        num = df.select_dtypes(include=[np.number]).fillna(0)
        y = (
            df["loan_status"].astype(str).str.contains("Fully Paid").astype(np.float32).values
            if "loan_status" in df
            else (num.iloc[:, 0] > num.iloc[:, 0].median()).astype(np.float32).values
        )
        x = num.values.astype(np.float32)[:, :d]
        x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    else:
        x, y = _synth_binary(n_samples, d, seed)
    xa, xb = vertical_split(x, list(LOAN_FEATURE_SPLITS))
    k = int(0.8 * len(y))
    return (xa[:k], xb[:k], y[:k]), (xa[k:], xb[k:], y[k:])
