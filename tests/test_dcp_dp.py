"""Invariant-driven imm_dp decode (db/dcp_dp.py).

No real imm-packed asset exists in this environment (the imm sources are
an external dependency the reference fetches at build time), so these
tests exercise the two halves that do not depend on imm's undocumented
schema: the walker/classifier over arbitrary msgpack nestings, and the
state-id-signature search + emission-extent invariants over synthetic
objects that satisfy/violate them.
"""

import struct

from deciphon_tpu.utils import msgpack
import numpy as np
import pytest

from deciphon_tpu.db import dcp_dp
from deciphon_tpu.db.dcp_dp import (
    DcpDpError, EMIT_POOL, decode_imm_dp, expected_state_ids,
    find_state_table, walk,
)


def state_ids_alt(k: int) -> list[int]:
    ids = [dcp_dp.S_ID, dcp_dp.N_ID, dcp_dp.B_ID]
    for i in range(1, k + 1):
        ids += [dcp_dp.MATCH | i, dcp_dp.INSERT | i, dcp_dp.DELETE | i]
    ids += [dcp_dp.E_ID, dcp_dp.J_ID, dcp_dp.C_ID, dcp_dp.T_ID]
    return ids


def synth_dp(k: int, is_alt: bool = True):
    """An imm_dp-shaped msgpack value satisfying every invariant: u16
    state ids, u32 emission offsets, f32 scores."""
    ids = state_ids_alt(k) if is_alt else [dcp_dp.R_ID]
    mute = {dcp_dp.S_ID, dcp_dp.B_ID, dcp_dp.E_ID, dcp_dp.T_ID} | {
        i for i in ids if (i >> 14) == 2
    }
    offs = [0]
    for sid in ids:
        offs.append(offs[-1] + (1 if sid in mute else EMIT_POOL))
    rng = np.random.default_rng(0)
    scores = -rng.random(offs[-1]).astype(np.float32)
    return {
        "state_table": {
            "ids": msgpack.ExtType(
                2, struct.pack(f"<{len(ids)}H", *ids)
            ),
            "start_lprob": -1.5,
            "end_state": len(ids) - 1,
        },
        "emis": {
            "offset": msgpack.ExtType(
                4, struct.pack(f"<{len(offs)}I", *offs)
            ),
            "score": msgpack.ExtType(10, scores.tobytes()),
        },
        "trans": {
            "score": msgpack.ExtType(
                10, (-rng.random(9 * k + 10).astype(np.float32)).tobytes()
            ),
        },
    }


def test_walk_classifies_nested_structures():
    obj = {
        "a": [1, 2, 3],
        "b": {"c": msgpack.ExtType(3, struct.pack("<4I", 1, 2, 3, 4))},
        "d": b"\x00" * 8,
        "e": 2.5,
    }
    leaves = walk(obj)
    paths = {leaf.path for leaf in leaves}
    assert "$.a[]" in paths
    assert any("$.b.c#ext3" in p for p in paths)
    ext = next(l for l in leaves if "ext3" in l.path)
    assert list(ext.ints["u32le"]) == [1, 2, 3, 4]


def test_state_signature_found_and_order_preserved():
    k = 5
    leaves = walk(synth_dp(k))
    hit = find_state_table(leaves, k, is_alt=True)
    assert hit is not None
    ids, where = hit
    assert "state_table.ids" in where
    assert set(ids.tolist()) == expected_state_ids(k)
    assert ids[0] == dcp_dp.S_ID  # file order preserved, not sorted


def test_decode_success_reports_sources():
    dp = decode_imm_dp(synth_dp(4), core_size=4, is_alt=True)
    assert dp.state_ids.size == 3 * 4 + 7
    assert dp.emis_offset[-1] == dp.emis_score.size
    assert "state_table.ids" in dp.report
    null = decode_imm_dp(synth_dp(4, False), core_size=4, is_alt=False)
    assert null.state_ids.tolist() == [dcp_dp.R_ID]


def test_decode_failure_carries_structural_inventory():
    # a plausible-looking object with no state-id signature
    obj = {"x": msgpack.ExtType(10, b"\x01\x02\x03\x04" * 7)}
    with pytest.raises(DcpDpError) as ei:
        decode_imm_dp(obj, core_size=3)
    msg = str(ei.value)
    assert "signature" in msg and "$.x#ext10" in msg


def test_decode_failure_when_emission_extents_wrong():
    dp = synth_dp(3)
    dp["emis"]["score"] = msgpack.ExtType(10, b"\x00" * 16)  # wrong pool
    with pytest.raises(DcpDpError, match="emission invariants"):
        decode_imm_dp(dp, core_size=3)


def test_dcp_profile_decode_dp_wiring(tmp_path):
    """DcpProfile.decode_dp runs the decoder on the parsed objects."""
    from tests.test_dcp import doc_bytes, profile_map

    from deciphon_tpu.db import dcp

    p = profile_map("PF00001.1", 3)
    p["null"] = synth_dp(3, False)
    p["alt"] = synth_dp(3, True)
    info = dcp.parse_dcp(doc_bytes([100], [p]))
    null, alt = info.profiles[0].decode_dp()
    assert alt.state_ids.size == 16
