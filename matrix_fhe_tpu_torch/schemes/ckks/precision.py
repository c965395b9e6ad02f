"""Precision statistics harness (numpy; a copy of
``matrix_fhe_tpu/schemes/ckks/precision.py``).

Counterpart of the reference's schemes/ckks/precision.go:26-200
(PrecisionStats / GetPrecisionStats / VerifyTestVectors): per-component
(real / imag / L2) min/max/avg/median/std log2 precision, an optional
cumulative distribution (the reference's ``computeDCF``), and the boxed
table rendering that makes precision regressions diagnosable at a glance.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Stats:
    """One statistic over the (real, imag, l2) error components."""
    real: float
    imag: float
    l2: float


@dataclasses.dataclass
class PrecisionStats:
    min_prec: Stats
    max_prec: Stats
    avg_prec: Stats
    med_prec: Stats
    std_prec: Stats
    # cumulative distribution: cdf[i] = (prec threshold, fraction of slots
    # with L2 precision >= threshold); empty unless compute_cdf
    cdf: list[tuple[float, float]]

    # backward-compatible scalar views (L2-based, the strictest component)
    @property
    def min_precision(self) -> float:
        return self.min_prec.l2

    @property
    def avg_precision(self) -> float:
        return self.avg_prec.l2

    @property
    def max_err(self) -> float:
        return 2.0 ** (-self.min_prec.l2)

    @property
    def avg_err(self) -> float:
        return 2.0 ** (-self.avg_prec.l2)

    def __str__(self) -> str:
        rows = [("MIN Prec", self.min_prec), ("MAX Prec", self.max_prec),
                ("AVG Prec", self.avg_prec), ("MED Prec", self.med_prec),
                ("STD Prec", self.std_prec)]
        out = ["+----------+--------+--------+--------+",
               "|     Log2 |  REAL  |  IMAG  |  L2    |",
               "+----------+--------+--------+--------+"]
        for name, s in rows:
            out.append(f"| {name:8s} | {s.real:6.2f} | {s.imag:6.2f} "
                       f"| {s.l2:6.2f} |")
        out.append("+----------+--------+--------+--------+")
        if self.cdf:
            out.append("CDF (fraction of slots with >= bits):")
            out.extend(f"  {t:6.2f} bits: {f:6.2%}" for t, f in self.cdf)
        return "\n".join(out)


def precision_stats(want, have, compute_cdf: bool = False,
                    cdf_points: int = 9) -> PrecisionStats:
    want = np.asarray(want, dtype=np.complex128)
    have = np.asarray(have, dtype=np.complex128)[: len(want)]
    diff = want - have
    comps = {
        "real": np.abs(diff.real),
        "imag": np.abs(diff.imag),
        "l2": np.abs(diff),
    }
    prec = {k: -np.log2(np.maximum(v, 1e-300)) for k, v in comps.items()}

    def stat(fn) -> Stats:
        return Stats(real=float(fn(prec["real"])),
                     imag=float(fn(prec["imag"])),
                     l2=float(fn(prec["l2"])))

    cdf: list[tuple[float, float]] = []
    if compute_cdf:
        p = prec["l2"]
        lo, hi = float(p.min()), float(p.max())
        for t in np.linspace(lo, hi, cdf_points):
            cdf.append((float(t), float(np.mean(p >= t))))

    return PrecisionStats(
        min_prec=stat(np.min), max_prec=stat(np.max), avg_prec=stat(np.mean),
        med_prec=stat(np.median), std_prec=stat(np.std), cdf=cdf)


def assert_precision(want, have, min_bits: float = 10.0) -> PrecisionStats:
    st = precision_stats(want, have)
    if st.min_precision < min_bits:
        raise AssertionError(f"precision too low:\n{st}\n(need {min_bits} "
                             f"bits min L2)")
    return st
