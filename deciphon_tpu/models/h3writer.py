"""HMMER3 ASCII save-file writer.

Inverse of models/h3reader.py — used for synthetic test fixtures and to
re-export profiles.  (The reference has no writer; its test assets are
downloaded Pfam files, test/CMakeLists.txt:10-28.  This environment has no
network, so fixtures are generated.)
"""

from __future__ import annotations

import numpy as np

from deciphon_tpu.models.alphabet import AMINO
from deciphon_tpu.models.h3reader import H3Profile


def _fmt(lp: float) -> str:
    """ln p -> HMMER3 '-ln p' column ('*' for p = 0)."""
    if not np.isfinite(lp):
        return "*"
    return f"{-lp:.5f}"


def _row(lps) -> str:
    return "  ".join(f"{_fmt(v):>8s}" for v in lps)


def write_h3(fp, profiles: list[H3Profile] | H3Profile) -> None:
    if isinstance(profiles, H3Profile):
        profiles = [profiles]
    for p in profiles:
        K = p.length
        fp.write("HMMER3/f [3.3.2 | deciphon_tpu]\n")
        fp.write(f"NAME  {p.name}\n")
        fp.write(f"ACC   {p.accession}\n")
        fp.write(f"LENG  {K}\n")
        fp.write("ALPH  amino\n")
        fp.write("RF    no\nMM    no\nCONS  yes\nCS    no\nMAP   yes\n")
        fp.write("HMM    " + "        ".join(AMINO.symbols) + "\n")
        fp.write(
            "        m->m     m->i     m->d     i->m     i->i     d->m"
            "     d->d\n"
        )
        fp.write("  COMPO  " + _row(np.log(np.full(20, 1 / 20))) + "\n")
        fp.write("         " + _row(p.insert_lprobs[0]) + "\n")
        fp.write("         " + _row(p.trans[0]) + "\n")
        cons = p.consensus or "-" * K
        for k in range(K):
            fp.write(
                f"{k + 1:7d}  " + _row(p.match_lprobs[k])
                + f"  {k + 1:6d} {cons[k]} - -\n"
            )
            fp.write("         " + _row(p.insert_lprobs[k]) + "\n")
            fp.write("         " + _row(p.trans[k + 1]) + "\n")
        fp.write("//\n")


def pfam_like_core_sizes(rng, n: int) -> np.ndarray:
    """Pfam-A-shaped core sizes: lognormal (median 150, sigma 0.8 — the
    bulk of Pfam-A lands in 30-600) clipped to 16..4096, plus forced
    1024/2048/4096 outliers so the reference envelope's widest tiers
    (core/limits.h:11) are always exercised."""
    tail = [1024, 2048, 4096] if n >= 64 else []
    sizes = np.exp(rng.normal(np.log(150.0), 0.8, n - len(tail)))
    sizes = np.clip(sizes, 16, 4096).astype(np.int64)
    return np.concatenate([sizes, tail]).astype(np.int64)


def random_h3(
    seed: int, core_size: int, name: str = "", peak: float = 0.0
) -> H3Profile:
    """Synthetic but HMMER-shaped profile for tests and benchmarks.

    ``peak`` > 0 concentrates each match distribution on one random amino
    acid (peak = its probability mass), making the profile informative the
    way a real Pfam match column is; 0 keeps flat random distributions.
    """
    rng = np.random.default_rng(seed)

    def dist(n):
        a = rng.random(n) + 1e-3
        return np.log(a / a.sum())

    def match_dist():
        lp = dist(20)
        if peak > 0:
            p = np.exp(lp) * (1.0 - peak)
            p[rng.integers(0, 20)] += peak
            lp = np.log(p / p.sum())
        return lp

    match = np.stack([match_dist() for _ in range(core_size)])
    inserts = np.stack([dist(20) for _ in range(core_size)])
    trans = []
    for i in range(core_size + 1):
        # realistic HMMER-like transition masses (match-dominated), jittered
        mm = 0.9 + 0.08 * rng.random()
        mi = (1 - mm) * rng.random()
        md = 1 - mm - mi
        im = 0.7 + 0.2 * rng.random()
        dm = 0.7 + 0.2 * rng.random()
        row = np.log(np.array([mm, mi, md, im, 1 - im, dm, 1 - dm]))
        if i == 0:
            row[6] = -np.inf  # no D0 -> D1
        if i == core_size:
            row[2] = -np.inf  # no M -> D_{K+1}
            row[6] = -np.inf
        trans.append(row)
    cons = "".join(
        AMINO.symbols[int(np.argmax(match[k]))].lower() for k in range(core_size)
    )
    nm = name or f"synth{seed}_{core_size}"
    return H3Profile(
        name=nm,
        accession=f"SYN{seed:05d}.{core_size}",
        length=core_size,
        match_lprobs=match,
        insert_lprobs=inserts,
        trans=np.stack(trans),
        consensus=cons,
    )
