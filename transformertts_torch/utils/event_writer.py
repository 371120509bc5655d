"""Self-contained TensorBoard event-file writer (no TensorFlow dependency).

The reference logs through tf.summary (the TF C++ runtime,
utils/logging_utils.py). This framework ships its own writer: TFRecord
framing (length + masked CRC32C) around hand-encoded ``tf.Event`` protobuf
messages, covering scalars, images, audio, histograms and text. Files are
readable by stock TensorBoard.

Proto field numbers (from tensorflow/core/util/event.proto and
tensorflow/core/framework/summary.proto):
  Event: wall_time=1(double) step=2(int64) file_version=3(string) summary=5
  Summary.Value: tag=1 simple_value=2(float) image=4 histo=5 audio=6
                 tensor=8 metadata=9
  Summary.Image: height=1 width=2 colorspace=3 encoded_image_string=4
  Summary.Audio: sample_rate=1(float) num_channels=2 length_frames=3
                 encoded_audio_string=4 content_type=5
  HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
                  bucket_limit=6(packed double) bucket=7(packed double)
"""
import io
import struct
import time
from pathlib import Path

import numpy as np

# ----------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _build_crc_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------- protobuf primitives

def _varint(n: int) -> bytes:
    # protobuf encodes negative int64 as its 64-bit two's complement
    # (10-byte varint); Python's arithmetic shift would loop forever on
    # negative n, so mask to 64 bits first
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack('<d', value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack('<f', value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_string(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode('utf-8'))


def _f_packed_doubles(field: int, values) -> bytes:
    payload = b''.join(struct.pack('<d', float(v)) for v in values)
    return _f_bytes(field, payload)


# ------------------------------------------------------------ summaries

def scalar_value(tag: str, value: float) -> bytes:
    return _f_bytes(1, _f_string(1, tag) + _f_float(2, float(value)))


def image_value(tag: str, png_bytes: bytes, height: int, width: int,
                colorspace: int = 4) -> bytes:
    img = (_f_varint(1, height) + _f_varint(2, width)
           + _f_varint(3, colorspace) + _f_bytes(4, png_bytes))
    return _f_bytes(1, _f_string(1, tag) + _f_bytes(4, img))


def audio_value(tag: str, wav_bytes: bytes, sample_rate: int,
                num_channels: int = 1, length_frames: int = 0) -> bytes:
    audio = (_f_float(1, float(sample_rate)) + _f_varint(2, num_channels)
             + _f_varint(3, length_frames)
             + _f_bytes(4, wav_bytes) + _f_string(5, 'audio/wav'))
    return _f_bytes(1, _f_string(1, tag) + _f_bytes(6, audio))


def histogram_value(tag: str, values: np.ndarray, bins: int = 30) -> bytes:
    values = np.asarray(values, np.float64).reshape(-1)
    if values.size == 0:
        values = np.zeros(1)
    counts, edges = np.histogram(values, bins=bins)
    histo = (_f_double(1, float(values.min()))
             + _f_double(2, float(values.max()))
             + _f_double(3, float(values.size))
             + _f_double(4, float(values.sum()))
             + _f_double(5, float(np.square(values).sum()))
             + _f_packed_doubles(6, edges[1:])
             + _f_packed_doubles(7, counts))
    return _f_bytes(1, _f_string(1, tag) + _f_bytes(5, histo))


def text_value(tag: str, text: str) -> bytes:
    # TensorProto: dtype=1 (DT_STRING=7), string_val=8
    tensor = _f_varint(1, 7) + _f_bytes(8, text.encode('utf-8'))
    # SummaryMetadata{ plugin_data=1: PluginData{ plugin_name=1 } }
    metadata = _f_bytes(1, _f_string(1, 'text'))
    return _f_bytes(1, (_f_string(1, tag) + _f_bytes(8, tensor)
                        + _f_bytes(9, metadata)))


def encode_event(step: int, value_bytes: bytes = None,
                 file_version: str = None, wall_time: float = None) -> bytes:
    ev = _f_double(1, wall_time if wall_time is not None else time.time())
    ev += _f_varint(2, int(step))
    if file_version is not None:
        ev += _f_string(3, file_version)
    if value_bytes is not None:
        ev += _f_bytes(5, value_bytes)  # Summary with repeated Value
    return ev


# ----------------------------------------------------------------- writer

class EventWriter:
    """Append-only TensorBoard event file in ``logdir``."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        fname = f'events.out.tfevents.{int(time.time())}.tpu.v2'
        self._f = open(self.logdir / fname, 'ab')
        self._write_record(encode_event(0, file_version='brain.Event:2'))

    def _write_record(self, data: bytes):
        header = struct.pack('<Q', len(data))
        self._f.write(header)
        self._f.write(struct.pack('<I', _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack('<I', _masked_crc(data)))

    def add_event(self, step: int, value_bytes: bytes):
        self._write_record(encode_event(step, value_bytes))

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_event(step, scalar_value(tag, value))

    def add_image_png(self, tag: str, png_bytes: bytes, height: int,
                      width: int, step: int):
        self.add_event(step, image_value(tag, png_bytes, height, width))

    def add_audio(self, tag: str, audio: np.ndarray, sample_rate: int,
                  step: int):
        """audio: float array in [-1, 1]; written as 16-bit PCM wav."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype('<i2')
        buf = io.BytesIO()
        _write_wav(buf, pcm, sample_rate)
        self.add_event(step, audio_value(tag, buf.getvalue(), sample_rate,
                                         1, len(pcm)))

    def add_histogram(self, tag: str, values, step: int, bins: int = 30):
        self.add_event(step, histogram_value(tag, values, bins))

    def add_text(self, tag: str, text: str, step: int):
        self.add_event(step, text_value(tag, text))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def _write_wav(buf, pcm: np.ndarray, sample_rate: int):
    n = len(pcm)
    data = pcm.tobytes()
    buf.write(b'RIFF')
    buf.write(struct.pack('<I', 36 + len(data)))
    buf.write(b'WAVEfmt ')
    buf.write(struct.pack('<IHHIIHH', 16, 1, 1, sample_rate,
                          sample_rate * 2, 2, 16))
    buf.write(b'data')
    buf.write(struct.pack('<I', len(data)))
    buf.write(data)
