"""tools/torch_profile_host.py at its small size on the CPU: every split
prints, with positive stage times, the host's core count, and a JPEG
decode stage sum that accounts for the composed path's time."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_profile_host as TPH  # noqa: E402


def test_profile_host_small(tmp_path, capsys):
    out = tmp_path / "splits.json"
    assert TPH.main(["--device", "cpu", "--small", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["split"] for r in rows] == [
        "jpeg_decode", "jp2_decode", "png_decode", "png_decode",
        "jpeg_encode"]
    assert all(r["cores"] == os.cpu_count() for r in rows)
    dec = rows[0]
    assert dec["geometry"] == "320x180"
    for k in ("header_ms", "validate_ms", "prep_ms", "decode_c_ms",
              "compose_ms", "compose_pool_ms"):
        assert dec[k] > 0, k
    assert 0 < dec["sum_over_compose_pool"] < 3
    jp2 = rows[1]
    assert jp2["tier1_ms"] > 0 and jp2["tier2_ms"] > 0
    assert 0 < jp2["tier1_share_of_host"] < 1
    assert all(r["inflate_ms"] > 0 and r["unfilter_ms"] > 0
               for r in rows[2:4])
    enc = rows[4]
    assert enc["batch"] == 8 and enc["optimize_bytes"] < enc["baseline_bytes"]
    assert all(enc[f"{t}_threads{k}_ms"] > 0 for t in ("baseline",
                                                        "optimize")
               for k in range(1, 9))
