"""MetricLogger + native TensorBoard event writer (no torch import)."""
import struct
import sys

import numpy as np

from rslo_tpu.utils.logging import MetricLogger
from rslo_tpu.utils.tb_writer import _masked_crc, crc32c


def _read_records(path):
    """Parse a TFRecord file, verifying both CRCs per record."""
    out = []
    data = path.read_bytes()
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(data[off:off + 8])
        rec = data[off + 12:off + 12 + n]
        (dcrc,) = struct.unpack_from("<I", data, off + 12 + n)
        assert dcrc == _masked_crc(rec)
        out.append(rec)
        off += 12 + n + 4
    return out


def test_crc32c_known_vectors():
    # RFC 3720 / kernel test vectors
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA


def test_metric_logger_writes_events(tmp_path):
    # torch must play no part in the TB path
    torch_loaded_before = "torch" in sys.modules
    ml = MetricLogger(str(tmp_path), tensorboard=True)
    ml.log_metrics({"loss": 1.5, "nested": {"a": 2.0}}, step=10)
    ml.log_image("bev", np.random.default_rng(0).uniform(
        size=(16, 24)).astype(np.float32), step=10)
    ml.close()
    if not torch_loaded_before:
        assert "torch" not in sys.modules

    evts = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert len(evts) == 1
    recs = _read_records(evts[0])
    # file_version header + 2 scalars + 1 image
    assert len(recs) == 4
    assert b"brain.Event:2" in recs[0]
    blob = b"".join(recs)
    assert b"loss" in blob and b"nested/a" in blob and b"bev" in blob
    # the image record carries a PNG
    assert b"\x89PNG" in recs[3]
    # jsonl written too
    assert (tmp_path / "log.json.lst").read_text().count('"step": 10') == 1
