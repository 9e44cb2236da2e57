"""Structural reader for reference .dcp databases.

No pressed .dcp asset ships with the reference checkout (its test fixtures
are downloaded at build time), so these tests synthesize documents that
follow the writer's layout exactly (src/db/writer.c:95-117 root map,
src/db/protein_writer.c:56-96 header keys, src/model/protein_profile.c
16-key profile maps) and pin every 1darray encoding the reader accepts.
"""

import struct

from deciphon_tpu.utils import msgpack
import pytest

from deciphon_tpu.db import dcp
from deciphon_tpu.utils.rc import DcpError


def profile_map(acc: str, core_size: int):
    m = {
        "accession": acc,
        "null": b"\x01" * 40,  # opaque imm_dp bin
        "alt": b"\x02" * 90,
        "core_size": core_size,
        "consensus": "A" * core_size,
    }
    # R,S,N,B,E,J,C,T special-state indices
    for i, k in enumerate(dcp._SPECIALS):
        m[k] = i + 1
    m["null_ndist"] = [b"\x03" * 8, b"\x04" * 16]
    m["alt_insert_ndist"] = [b"\x03" * 8, b"\x04" * 16]
    m["alt_match_ndist"] = [[b"\x03" * 8, b"\x04" * 16]] * core_size
    return m


def doc_bytes(profile_sizes, profiles, magic=dcp.DCP_MAGIC, epsilon=0.01):
    root = {
        "header": {
            "magic_number": magic,
            "profile_typeid": 2,
            "float_size": 4,
            "entry_dist": 2,
            "epsilon": epsilon,
            "abc": b"\x07" * 24,
            "amino": b"\x08" * 44,
            "profile_sizes": profile_sizes,
        },
        "profiles": profiles,
    }
    return msgpack.packb(root, use_bin_type=True)


PROFILES = [profile_map("PF00001.1", 3), profile_map("PF00002.2", 5)]
SIZES = [511, 777]


def check(info):
    assert info.magic == dcp.DCP_MAGIC
    assert info.typeid_name == "protein"
    assert info.entry_dist_name == "occupancy"
    assert info.float_size == 4
    assert info.epsilon == pytest.approx(0.01)
    assert info.profile_sizes == SIZES
    assert [p.accession for p in info.profiles] == ["PF00001.1", "PF00002.2"]
    assert [p.core_size for p in info.profiles] == [3, 5]
    assert info.profiles[0].consensus == "AAA"
    assert info.profiles[0].specials == dict(
        zip(dcp._SPECIALS, range(1, 9))
    )
    assert info.profiles[0].null_dp_nbytes == 40
    assert info.profiles[0].alt_dp_nbytes == 90


def test_plain_array_sizes():
    check(dcp.parse_dcp(doc_bytes(SIZES, PROFILES)))


def test_ext_1darray_sizes_big_endian():
    ext = msgpack.ExtType(3, struct.pack(">2I", *SIZES))
    check(dcp.parse_dcp(doc_bytes(ext, PROFILES)))


def test_ext_1darray_sizes_little_endian():
    ext = msgpack.ExtType(3, struct.pack("<2I", *SIZES))
    check(dcp.parse_dcp(doc_bytes(ext, PROFILES)))


def test_bad_magic_rejected():
    with pytest.raises(DcpError, match="magic"):
        dcp.parse_dcp(doc_bytes(SIZES, PROFILES, magic=0xD7B0))


def test_not_msgpack_rejected():
    with pytest.raises(DcpError, match="MessagePack"):
        dcp.parse_dcp(b"\xc1 not msgpack")


def test_count_mismatch_rejected():
    with pytest.raises(DcpError, match="mismatch"):
        dcp.parse_dcp(doc_bytes([1, 2, 3], PROFILES))


def test_read_dcp_file_and_cli_info(tmp_path, capsys):
    p = tmp_path / "ref.dcp"
    p.write_bytes(doc_bytes(SIZES, PROFILES))
    check(dcp.read_dcp(str(p)))

    from deciphon_tpu.cli.main import main

    assert main(["info", str(p)]) == 0
    out = capsys.readouterr().out
    assert "reference .dcp" in out and "profiles:   2" in out
