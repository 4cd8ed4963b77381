"""Binary wire framing — the length-prefixed frame the shard protocol

A copy of ``flink_parameter_server_tpu/utils/frames.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

negotiates up to (ROADMAP item 1, docs/cluster.md "Binary framing").

The latency budget (telemetry/profiler.py) said it plainly: on the b64 line protocol, wire
is 60.9% of the pull round and base64+text parse/serialize another
~18% — the win is framing, not more payload tweaks.  This module is
that framing: a fixed 24-byte little-endian header (magic, version,
verb id, payload encoding, priority/status, epoch/aux), a bounded TLV
section for the trailing-option vocabulary the line protocol grew
over time (``t=`` trace tokens, ``pid=``, ``sess=``, piggybacked ``inv=``,
…), an id section of raw ``<i8``, and a payload of raw ``<f4`` (or
bf16) row bytes received **zero-copy** into ``memoryview``\\ s — no
base64, no ``repr()``, no ``str.split``.

Negotiation is per-connection and line-first (docs/cluster.md): a
client opens with the TEXT line ``hello bin v=1``.  A binary-capable
server answers ``ok proto=bin v=1`` and accepts binary frames on that
connection from then on (it still accepts text lines — each inbound
frame is self-describing by its two magic bytes, which are non-ASCII
and therefore can never alias a text verb).  An old server answers
``err bad-request: unknown command 'hello'`` and the client stays on
the line protocol — the trailing-token versioning contract, now covering the
whole framing instead of one trailing token.

Frame layout (everything little-endian)::

    u16  magic       0xF5B1  (wire bytes b1 f5 — both non-ASCII)
    u8   version     1
    u8   verb        VERB_IDS (requests) / echo of the request (responses)
    u8   enc         payload encoding: 0 fp32, 1 bf16, 2 raw bytes
    u8   flag        requests: priority (255 = none)
                     responses: status (0 ok, else STATUS_* error code)
    u16  tlv_len     bytes of TLV section
    i64  epoch/aux   requests: partition-map epoch (-1 = none)
                     responses: verb-specific (push/lease/xfer/load: seq)
    u32  n           requests: id count (the id section is n × i64)
                     responses: row/ack count
    u32  body_len    tlv_len + id section + payload, in bytes
    ---- body: TLVs, then ids (requests only), then payload ----

TLVs are ``u8 type, u16 len, bytes`` with ASCII values — they carry the
small option vocabulary, never row data.  Unknown TLV types are
parse-and-ignored (the binary analogue of the trailing-token
contract), so the option vocabulary can keep growing.

Payload encodings: ``ENC_F32`` is exact (bitwise the stored row — what
BSP parity rides on); ``ENC_BF16`` truncates each fp32 to its top 16
bits (half the bytes, opt-in, lossy); ``ENC_RAW`` is opaque bytes
(JSON stats answers, shipped WAL records).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0xF5B1
MAGIC_BYTES = struct.pack("<H", MAGIC)  # b"\xb1\xf5"
VERSION = 1
_HDR = struct.Struct("<HBBBBHqII")
HEADER_SIZE = _HDR.size  # 24
assert HEADER_SIZE == 24

# the line-protocol negotiation handshake (docs/cluster.md)
HELLO_LINE = f"hello bin v={VERSION}"
HELLO_OK = f"ok proto=bin v={VERSION}"

NO_PRIORITY = 255
NO_EPOCH = -1

# verb ids — one byte on the wire; names match the line protocol so
# the NetMeter ledger and the profiler phases stay one vocabulary
VERB_IDS: Dict[str, int] = {
    "pull": 1,
    "push": 2,
    "lease": 3,
    "revoke": 4,
    "xfer": 5,
    "load": 6,
    "repl": 7,
    "replstate": 8,
    "flush": 9,
    "stats": 10,
    "conns": 11,
}
VERB_NAMES: Dict[int, str] = {v: k for k, v in VERB_IDS.items()}

# payload encodings
ENC_F32 = 0
ENC_BF16 = 1
ENC_RAW = 2
# per-row-scaled int8 deltas (compression/quantizers.py): payload is
# n × width raw int8, the f32 row scales ride a T_SCALE TLV.  A PUSH
# codec only — pull/lease answers never quantize (absolute values
# carry no residual to re-inject; docs/compression.md)
ENC_Q8 = 3
ENC_NAMES = {ENC_F32: "f32", ENC_BF16: "bf16", ENC_RAW: "raw",
             ENC_Q8: "q8"}

# the quantized encodings a binary-capable server ADVERTISES on its
# hello answer ("ok proto=bin v=1 enc=bf16,q8" — hello_encs parses the
# token back).  Old binary servers answer without the token; a client
# must then assume bf16 only (the first binary vocabulary) and downgrade q8
# frames to exact f32 — the negotiation matrix in docs/compression.md.
WIRE_ENCS = ("bf16", "q8")
LEGACY_BIN_ENCS = frozenset({"bf16"})


def hello_ok_line(encs: Tuple[str, ...] = WIRE_ENCS) -> str:
    """The binary-capable server's hello answer, advertising its
    quantized-encoding vocabulary as a trailing token (old clients
    check the ``ok proto=bin`` prefix only — parse-and-ignored)."""
    return HELLO_OK + (" enc=" + ",".join(encs) if encs else "")


def hello_encs(resp: str) -> frozenset:
    """Quantized encodings negotiated from a server's hello answer:
    the ``enc=`` token when present, else the legacy bf16-only set
    (an older binary server predates the token)."""
    for tok in resp.split()[1:]:
        if tok.startswith("enc="):
            return frozenset(
                e for e in tok[4:].split(",") if e
            )
    return LEGACY_BIN_ENCS

# response status codes — one byte; the mapping mirrors the line
# protocol's ``err <reason>`` vocabulary exactly
STATUS_OK = 0
STATUS_BAD_REQUEST = 1
STATUS_CRASHED = 2
STATUS_STALE_EPOCH = 3
STATUS_FROZEN = 4
STATUS_LAGGING = 5
STATUS_NOT_PRIMARY = 6
STATUS_OVERLOADED = 7
STATUS_INTERNAL = 8
STATUS_NAMES = {
    STATUS_OK: "ok",
    STATUS_BAD_REQUEST: "bad-request",
    STATUS_CRASHED: "crashed",
    STATUS_STALE_EPOCH: "stale-epoch",
    STATUS_FROZEN: "frozen",
    STATUS_LAGGING: "lagging",
    STATUS_NOT_PRIMARY: "not-primary",
    STATUS_OVERLOADED: "overloaded",
    STATUS_INTERNAL: "internal",
}

# TLV types (ASCII values; unknown types are parse-and-ignored)
T_TRACE = 1  # t=<trace>:<span> token (telemetry/distributed.py)
T_PID = 2  # exactly-once push token
T_SESS = 3  # hot-key lease session (hotcache/)
T_INV = 4  # piggybacked invalidations: id list or "*"
T_TTL = 5  # lease ttl (request: asked; response: granted)
T_ERR = 6  # error detail string (responses)
T_EPOCH = 7  # shard epoch on err stale-epoch
T_LAG = 8  # follower lag on err lagging
T_HEAD = 9  # primary head seq on repl frames
T_SEG = 10  # follower ack segment on repl answers
T_APPLIED = 11  # applied count (repl answers)
T_WALREC = 12  # wal_records (flush answers)
T_SCALE = 13  # raw <f4 per-row scales of an ENC_Q8 payload

_MAX_TLVS = 64
_MAX_FRAME_DEFAULT = 64 << 20


class FrameError(ValueError):
    """A malformed binary frame (bad magic/version, short body,
    inconsistent section lengths).  Server-side it maps to
    ``STATUS_BAD_REQUEST``; client-side it is a protocol error."""


@dataclasses.dataclass
class Frame:
    """One decoded frame, request or response.

    ``ids`` and ``payload`` are ZERO-COPY views into the receive
    buffer (``np.frombuffer`` / ``memoryview``) — read-only; a consumer
    that stores rows past the call must copy."""

    verb: int
    enc: int
    flag: int  # priority (requests) / status (responses)
    aux: int  # epoch (requests) / verb-specific (responses)
    n: int
    tlvs: Dict[int, bytes]
    ids: Optional[np.ndarray]
    payload: memoryview

    @property
    def verb_name(self) -> str:
        return VERB_NAMES.get(self.verb, "other")

    @property
    def status_name(self) -> str:
        return STATUS_NAMES.get(self.flag, f"status-{self.flag}")

    def tlv_str(self, t: int) -> Optional[str]:
        v = self.tlvs.get(t)
        return None if v is None else v.decode("ascii", "replace")

    def tlv_int(self, t: int) -> Optional[int]:
        v = self.tlv_str(t)
        if v is None:
            return None
        try:
            return int(v)
        except ValueError:
            return None


def _pack_tlvs(tlvs: Sequence[Tuple[int, bytes]]) -> bytes:
    if not tlvs:
        return b""
    parts: List[bytes] = []
    for t, val in tlvs:
        if isinstance(val, str):
            val = val.encode("ascii")
        if len(val) > 0xFFFF:
            raise FrameError(f"TLV {t} value of {len(val)} bytes")
        parts.append(struct.pack("<BH", int(t), len(val)))
        parts.append(bytes(val))
    return b"".join(parts)


def _parse_tlvs(view: memoryview) -> Dict[int, bytes]:
    out: Dict[int, bytes] = {}
    off = 0
    n = 0
    end = len(view)
    while off < end:
        if off + 3 > end:
            raise FrameError("truncated TLV header")
        t = view[off]
        (ln,) = struct.unpack_from("<H", view, off + 1)
        off += 3
        if off + ln > end:
            raise FrameError(f"TLV {t}: {ln} bytes past section end")
        n += 1
        if n > _MAX_TLVS:
            raise FrameError(f"more than {_MAX_TLVS} TLVs")
        # first occurrence wins; unknown types are kept (callers
        # ignore what they do not know — the versioning contract)
        out.setdefault(t, bytes(view[off: off + ln]))
        off += ln
    return out


def encode_request(
    verb: int,
    *,
    ids: Optional[np.ndarray] = None,
    payload: bytes = b"",
    enc: int = ENC_F32,
    epoch: Optional[int] = None,
    priority: Optional[int] = None,
    tlvs: Sequence[Tuple[int, bytes]] = (),
) -> bytes:
    """One request frame.  ``ids`` any int array (encoded ``<i8``);
    ``payload`` already in ``enc`` (see :func:`rows_to_payload`)."""
    id_bytes = b""
    n_ids = 0
    if ids is not None:
        arr = np.ascontiguousarray(np.asarray(ids, dtype="<i8"))
        id_bytes = arr.tobytes()
        n_ids = int(arr.size)
    tlv_bytes = _pack_tlvs(tlvs)
    body_len = len(tlv_bytes) + len(id_bytes) + len(payload)
    hdr = _HDR.pack(
        MAGIC, VERSION, int(verb), int(enc),
        NO_PRIORITY if priority is None else int(priority) & 0xFF,
        len(tlv_bytes),
        NO_EPOCH if epoch is None else int(epoch),
        n_ids, body_len,
    )
    return b"".join((hdr, tlv_bytes, id_bytes, payload))


def encode_response(
    verb: int,
    *,
    status: int = STATUS_OK,
    aux: int = 0,
    n: int = 0,
    payload: bytes = b"",
    enc: int = ENC_F32,
    tlvs: Sequence[Tuple[int, bytes]] = (),
) -> bytes:
    tlv_bytes = _pack_tlvs(tlvs)
    body_len = len(tlv_bytes) + len(payload)
    hdr = _HDR.pack(
        MAGIC, VERSION, int(verb), int(enc), int(status) & 0xFF,
        len(tlv_bytes), int(aux), int(n), body_len,
    )
    return b"".join((hdr, tlv_bytes, payload))


def error_response(
    verb: int, status: int, detail: str = "",
    tlvs: Sequence[Tuple[int, bytes]] = (),
) -> bytes:
    extra = list(tlvs)
    if detail:
        extra.append((T_ERR, detail.encode("ascii", "replace")[:512]))
    return encode_response(verb, status=status, enc=ENC_RAW, tlvs=extra)


def peek_header(buf) -> Tuple[int, int, int, int]:
    """``(verb, enc, flag, total_frame_len)`` from the first 24 bytes
    of ``buf`` — the pre-parse peek the overload guard and the byte
    ledger read before any body work."""
    if len(buf) < HEADER_SIZE:
        raise FrameError(f"short header ({len(buf)} bytes)")
    magic, ver, verb, enc, flag, _tl, _aux, _n, body_len = (
        _HDR.unpack_from(buf, 0)
    )
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:04x}")
    if ver != VERSION:
        raise FrameError(f"unsupported frame version {ver}")
    return verb, enc, flag, HEADER_SIZE + body_len


def decode(buf, *, kind: str = "request") -> Frame:
    """Decode one complete frame (header + body).  ``kind`` decides
    whether an id section follows the TLVs (requests carry one,
    responses never do).  ``ids``/``payload`` are views into ``buf``."""
    view = memoryview(buf)
    if len(view) < HEADER_SIZE:
        raise FrameError(f"short frame ({len(view)} bytes)")
    return decode_split(view[:HEADER_SIZE], view[HEADER_SIZE:], kind=kind)


def decode_split(hdr, body, *, kind: str = "request") -> Frame:
    """:func:`decode` over a header and body held in SEPARATE buffers
    — the client read path peels the 24-byte header first to learn the
    body length, and joining the two would copy the whole payload just
    to split it again.  ``ids``/``payload`` are views into ``body``."""
    magic, ver, verb, enc, flag, tlv_len, aux, n, body_len = (
        _HDR.unpack_from(hdr, 0)
    )
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:04x}")
    if ver != VERSION:
        raise FrameError(f"unsupported frame version {ver}")
    body = memoryview(body)
    if len(body) != body_len:
        raise FrameError(
            f"frame body is {len(body)} bytes but header says "
            f"{body_len}"
        )
    if tlv_len > len(body):
        raise FrameError(f"TLV section {tlv_len} past body end")
    tlvs = _parse_tlvs(body[:tlv_len]) if tlv_len else {}
    rest = body[tlv_len:]
    ids = None
    if kind == "request":
        id_bytes = 8 * n
        if id_bytes > len(rest):
            raise FrameError(
                f"id section of {n} ids past body end ({len(rest)} "
                f"bytes left)"
            )
        ids = np.frombuffer(rest[:id_bytes], dtype="<i8")
        rest = rest[id_bytes:]
    return Frame(
        verb=verb, enc=enc, flag=flag, aux=aux, n=n, tlvs=tlvs,
        ids=ids, payload=rest,
    )


# -- payload codecs -----------------------------------------------------------


def rows_to_payload(rows: np.ndarray, enc: int = ENC_F32) -> bytes:
    """Row bytes for the wire: fp32 little-endian row-major (exact —
    bitwise the stored row), or bf16 (top 16 bits of each fp32 —
    half the bytes, lossy, opt-in)."""
    arr = np.ascontiguousarray(np.asarray(rows, dtype="<f4"))
    if enc == ENC_F32:
        return arr.tobytes()
    if enc == ENC_BF16:
        return (
            (arr.view("<u4") >> np.uint32(16)).astype("<u2").tobytes()
        )
    raise FrameError(f"enc={enc}: not a row encoding")


def rows_from_payload(
    payload, value_shape: Tuple[int, ...], enc: int
) -> np.ndarray:
    """Inverse of :func:`rows_to_payload` → ``(n, *value_shape)``
    float32.  The fp32 path is ZERO-COPY (``np.frombuffer`` over the
    receive view, read-only); bf16 widens (one copy by necessity)."""
    width = 1
    for s in value_shape:
        width *= int(s)
    if enc == ENC_F32:
        flat = np.frombuffer(payload, dtype="<f4")
    elif enc == ENC_BF16:
        flat = (
            np.frombuffer(payload, dtype="<u2").astype(np.uint32)
            << np.uint32(16)
        ).view(np.float32)
    else:
        raise FrameError(f"enc={enc}: not a row encoding")
    if width == 0 or flat.size % width:
        raise FrameError(
            f"payload of {flat.size} values does not tile value shape "
            f"{value_shape}"
        )
    return flat.reshape((flat.size // width,) + tuple(value_shape))


# -- link-level helpers (shared by client, server loop, chaos proxy) ---------


def peek_is_binary(buf) -> bool:
    """Do the next bytes open a binary frame?  The two magic bytes are
    non-ASCII, so a text line can never alias them — each frame on a
    negotiated connection is self-describing."""
    return len(buf) >= 2 and bytes(buf[:2]) == MAGIC_BYTES


def frame_length(buf) -> Optional[int]:
    """Total length of the binary frame opening at ``buf[0]``, or None
    while the fixed header is still incomplete."""
    if len(buf) < HEADER_SIZE:
        return None
    (body_len,) = struct.unpack_from("<I", buf, HEADER_SIZE - 4)
    return HEADER_SIZE + body_len


def peek_verb_name(buf) -> str:
    """Best-effort verb name from an encoded frame's header byte — the
    wire-ledger label (never raises; unknown → "other")."""
    try:
        return VERB_NAMES.get(bytes(buf[:HEADER_SIZE])[3], "other")
    except Exception:
        return "other"


__all__ = [
    "ENC_BF16",
    "ENC_F32",
    "ENC_NAMES",
    "ENC_Q8",
    "ENC_RAW",
    "Frame",
    "FrameError",
    "HEADER_SIZE",
    "HELLO_LINE",
    "HELLO_OK",
    "MAGIC",
    "MAGIC_BYTES",
    "NO_EPOCH",
    "NO_PRIORITY",
    "STATUS_BAD_REQUEST",
    "STATUS_CRASHED",
    "STATUS_FROZEN",
    "STATUS_INTERNAL",
    "STATUS_LAGGING",
    "STATUS_NAMES",
    "STATUS_NOT_PRIMARY",
    "STATUS_OK",
    "STATUS_OVERLOADED",
    "STATUS_STALE_EPOCH",
    "T_APPLIED",
    "T_EPOCH",
    "T_ERR",
    "T_HEAD",
    "T_INV",
    "T_LAG",
    "T_PID",
    "T_SCALE",
    "T_SEG",
    "T_SESS",
    "T_TRACE",
    "T_TTL",
    "T_WALREC",
    "VERB_IDS",
    "VERB_NAMES",
    "VERSION",
    "WIRE_ENCS",
    "decode",
    "decode_split",
    "encode_request",
    "encode_response",
    "error_response",
    "frame_length",
    "hello_encs",
    "hello_ok_line",
    "peek_header",
    "peek_is_binary",
    "peek_verb_name",
    "rows_from_payload",
    "rows_to_payload",
]
