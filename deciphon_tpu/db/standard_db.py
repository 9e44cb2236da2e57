"""Standard-profile (typeid 1) database container.

The generic-profile counterpart of the protein .dtp writer/reader
(db/format.py), mirroring the reference's generic db layer which packs
any profile kind behind the typeid dispatch (src/db/writer.c:95-117 root
map, src/db/profile_reader.c vtable unpack).  One msgpack map:
{header: {magic, typeid, version, nprofiles, abc}, profiles: [...]}.
"""

from __future__ import annotations

import numpy as np

from deciphon_tpu.models.alphabet import DNA, AMINO, Alphabet
from deciphon_tpu.models.standard import StandardProfile
from deciphon_tpu.utils.rc import eparse

MAGIC = 0xC6F0  # reference src/db/types.h:11
TYPEID_STANDARD = 1  # src/model/profile_typeid.h:4-9

_ABCS = {"dna": DNA, "amino": AMINO}


def _arr(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(np.asarray(a, np.float64))
    return {"shape": list(a.shape), "data": a.tobytes()}


def _unarr(d: dict) -> np.ndarray:
    return np.frombuffer(d["data"], np.float64).reshape(d["shape"]).copy()


def write_standard_db(path: str, profiles: list[StandardProfile]) -> int:
    from deciphon_tpu.utils import msgpack

    doc = {
        "header": {
            "magic_number": MAGIC,
            "profile_typeid": TYPEID_STANDARD,
            "float_size": 8,
            "nprofiles": len(profiles),
            "abc": profiles[0].abc.name if profiles else "dna",
        },
        "profiles": [
            {
                "accession": p.accession,
                "name": p.name,
                "alt_start": _arr(p.alt_start),
                "alt_trans": _arr(p.alt_trans),
                "alt_emis": _arr(p.alt_emis),
                "alt_end": _arr(p.alt_end),
                "null_start": _arr(p.null_start),
                "null_trans": _arr(p.null_trans),
                "null_emis": _arr(p.null_emis),
                "null_end": _arr(p.null_end),
            }
            for p in profiles
        ],
    }
    with open(path, "wb") as fp:
        fp.write(msgpack.packb(doc))
    return len(profiles)


def load_standard_db(path: str) -> list[StandardProfile]:
    from deciphon_tpu.utils import msgpack

    with open(path, "rb") as fp:
        doc = msgpack.unpackb(fp.read())
    hdr = doc["header"]
    if hdr["magic_number"] != MAGIC:
        raise eparse("wrong magic number")
    if hdr["profile_typeid"] != TYPEID_STANDARD:
        raise eparse(
            f"not a standard-profile db (typeid {hdr['profile_typeid']})"
        )
    abc: Alphabet = _ABCS[hdr["abc"]]
    return [
        StandardProfile(
            accession=p["accession"],
            name=p.get("name", ""),
            abc=abc,
            alt_start=_unarr(p["alt_start"]),
            alt_trans=_unarr(p["alt_trans"]),
            alt_emis=_unarr(p["alt_emis"]),
            alt_end=_unarr(p["alt_end"]),
            null_start=_unarr(p["null_start"]),
            null_trans=_unarr(p["null_trans"]),
            null_emis=_unarr(p["null_emis"]),
            null_end=_unarr(p["null_end"]),
        )
        for p in doc["profiles"]
    ]
