"""Survival evaluation: metrics (CIndex, IBS, support F1) and the k-fold
cross-validation protocol."""
