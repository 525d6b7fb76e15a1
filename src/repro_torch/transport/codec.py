"""Wire codec: length-prefixed binary frames for the inference transport.

A copy of ``repro.transport.codec`` (numpy only), kept byte-compatible
with it: a frame either package encodes, the other decodes.

The hot path of a disaggregated SEED deployment is (obs -> action) at env
frame rate, so the codec is deliberately dumb and fast: a fixed header,
C-contiguous ndarray bytes with an explicit dtype/shape prologue, and
NO pickle anywhere — a malicious or corrupted peer can produce garbage
arrays, never code execution. Frame kinds cover the whole protocol:

  * ``REQUEST``     actor -> gateway: one lane-batched ``obs[E, ...]`` plus
    the ``actor_id`` that keys the server's per-(actor, lane) recurrent
    slots and a per-connection ``request_id`` for reply demultiplexing;
  * ``REPLY``       gateway -> actor: the ``(E,)`` action array for a
    request; the learner's published ``param_version`` rides the header's
    dedicated version field so remote actors can staleness-stamp unrolls;
  * ``ERROR``       gateway -> actor (or broadcast with ``request_id == 0``):
    a UTF-8 message — the wire form of the poison ``ReplyError`` that
    fail-fast shutdown puts on in-process reply queues;
  * ``TRAJ``        actor -> gateway: a dict of named arrays (one per-lane
    unroll in the ``flush_lane_unrolls`` schema) feeding the learner-side
    trajectory sink, so trajectories ride the same connection;
  * ``TRAJ_BATCH``  actor -> gateway: SEVERAL such unroll dicts coalesced
    into one frame, so one syscall (or one shm-ring slot) carries a whole
    actor flush — an actor with E lanes emits E unroll records per flush,
    and without coalescing each was its own frame + syscall;
  * ``HELLO``       both ways: a u32 codec capability bitmask. A client
    that wants an optional encoding sends one at connect; the gateway
    answers with the intersection of the two masks, and only then does
    the client start using the granted encodings — negotiation per
    connection, so a plain peer never sees a frame it cannot decode;
  * ``SHM``         actor -> gateway: shared-memory ring attachment — the
    names + geometry of a (c2s, s2c) `repro_torch.transport.shm.ShmRing` pair
    the client created. Only sent after the gateway granted ``CODEC_SHM``
    (co-located peers); subsequent frames ride the rings with the TCP
    connection kept as spill + liveness channel.

Header ``param_version`` (wire v2): the REPLY header carries the learner's
published param version in a dedicated u32 field. (v1 smuggled it through
the unused ``actor_id`` slot; v2 gives it a real field and rejects
mismatched version bytes outright — feature interop WITHIN v2 is what the
HELLO grant negotiates.) On-policy metadata (``CODEC_ONPOLICY``): TRAJ
dicts additionally carry ``behavior_logprobs`` per step and a
``param_version`` stamp per unroll, gated on the HELLO grant exactly like
compression — an un-granted client strips the keys.

Header ``trace_seq`` (wire v3): a u32 telemetry sequence id
(`repro_torch.telemetry.tracer.next_trace_seq`) in a dedicated header field on every
frame. A traced actor stamps its REQUEST, the gateway threads it through
the replica and echoes it on the REPLY, and TRAJ/TRAJ_BATCH flushes carry
their own — so one logical round-trip stitches into a single Perfetto
flow across actor-host, gateway, and learner processes. 0 means untraced
(the default; telemetry off costs four zero bytes per frame).

Per-array encodings (the ``enc`` byte in every ndarray prologue):

  * ``ENC_RAW``  raw C-order bytes — always valid, the fallback;
  * ``ENC_RLE``  (``CODEC_RLE``): uint8 payloads run-length encoded as
    (count u8, value u8) pairs — Atari frame lanes shrink well;
  * ``ENC_F16``  (``CODEC_QUANT``): float32 payloads stored as float16 —
    2x smaller, error bounded by f16 rounding (~2^-11 relative);
  * ``ENC_Q8``   (``CODEC_QUANT``): float32 payloads stored as affine
    uint8 with per-array (scale, offset) in the prologue — 4x smaller,
    max abs error scale/2 where scale = (max - min) / 255.

Every optional encoding obeys the same only-when-smaller discipline: it is
used per array only when the encoded payload is strictly smaller than raw,
and the array's ``enc`` byte records what was actually done (frame-level
``FLAG_*`` bits mirror the choice for cheap stats). Decoding checks the
expansion target against the shape BEFORE allocating — bounded by the same
``max_frame`` the stream reader enforces — and unknown enc bytes or flag
bits are rejected before any payload allocation, so a hostile stream
cannot balloon memory through the codec.

Zero-copy: ``encode_*_parts`` variants return a list of buffer views
(header/prologue bytes interleaved with memoryviews over the source
arrays) for scatter-gather sends (``socket.sendmsg`` / shm-ring writes) —
no concatenation copy; the plain ``encode_*`` functions join the parts for
callers that want one bytes object. ``decode_frame(..., zero_copy=True)``
returns ndarrays as read-only views over the frame body where alignment
permits (the views keep the body alive) instead of copying each array out.

Framing::

    frame   := u32 body_len | body                      (big-endian)
    body    := u16 magic | u8 ver | u8 kind | u8 flags
               | u32 actor_id | u64 request_id | u32 param_version
               | u32 trace_seq | payload
    ndarray := u8 enc | u8 dtype_len | dtype_str | u8 ndim | ndim * u32 dim
               | [enc==Q8: f4 scale | f4 offset]
               | u64 nbytes | payload bytes
    traj    := u16 count | count * (u8 key_len | key | ndarray)
    batch   := u16 n_trajs | n_trajs * traj
    hello   := u32 codec_mask
    shm     := u8 len | c2s_name | u8 len | s2c_name
               | u32 slot_size | u32 num_slots

Truncated frames (EOF or short buffer mid-frame) raise ``TruncatedFrame``;
a length prefix beyond ``max_frame`` raises ``FrameTooLarge`` before any
allocation, so a desynchronized or hostile stream cannot balloon memory.
"""

import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0x5254           # "RT" — repro transport
VERSION = 3              # v3: trace_seq header field (v2: param_version)

KIND_REQUEST = 1
KIND_REPLY = 2
KIND_ERROR = 3
KIND_TRAJ = 4
KIND_HELLO = 5
KIND_TRAJ_BATCH = 6
KIND_SHM = 7

FLAG_SCALAR = 0x01       # legacy single-obs submit: reply unwraps to obs[0]
FLAG_RLE = 0x02          # >=1 ndarray payload in this frame is ENC_RLE
FLAG_F16 = 0x04          # >=1 ndarray payload in this frame is ENC_F16
FLAG_Q8 = 0x08           # >=1 ndarray payload in this frame is ENC_Q8
_KNOWN_FLAGS = FLAG_SCALAR | FLAG_RLE | FLAG_F16 | FLAG_Q8
_ARRAY_FLAGS = FLAG_RLE | FLAG_F16 | FLAG_Q8

# per-array encoding byte (the payload truth; frame flags are the record)
ENC_RAW = 0
ENC_RLE = 1
ENC_F16 = 2
ENC_Q8 = 3
_ENC_FLAG = {ENC_RLE: FLAG_RLE, ENC_F16: FLAG_F16, ENC_Q8: FLAG_Q8}

CODEC_RLE = 0x01         # HELLO bit: ENC_RLE for uint8 payloads
CODEC_ONPOLICY = 0x02    # HELLO bit: on-policy TRAJ metadata + versions
CODEC_QUANT = 0x04       # HELLO bit: ENC_F16 / ENC_Q8 float framing
CODEC_TRAJBATCH = 0x08   # HELLO bit: KIND_TRAJ_BATCH coalescing
CODEC_SHM = 0x10         # HELLO bit: shared-memory ring transport
SUPPORTED_CODECS = (CODEC_RLE | CODEC_ONPOLICY | CODEC_QUANT
                    | CODEC_TRAJBATCH | CODEC_SHM)

DEFAULT_MAX_FRAME = 64 << 20      # 64 MiB: > any sane lane batch or unroll

_F16_MAX = 65504.0       # largest finite float16

_LEN = struct.Struct(">I")
# magic, ver, kind, flags, actor_id, request_id, param_version, trace_seq
_HEADER = struct.Struct(">HBBBIQII")
_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_F32 = struct.Struct(">f")
_Q8PARAMS = struct.Struct(">ff")   # scale, offset


class CodecError(ValueError):
    """Malformed frame (bad magic/version/kind/dtype, trailing bytes...)."""


class TruncatedFrame(CodecError):
    """Stream or buffer ended in the middle of a frame."""


class FrameTooLarge(CodecError):
    """Length prefix exceeds the configured max frame size."""


@dataclass
class Frame:
    kind: int
    actor_id: int = 0
    request_id: int = 0
    flags: int = 0
    param_version: int = 0                   # REPLY: learner's published v
    trace_seq: int = 0                       # telemetry stitch id (0 = off)
    array: Optional[np.ndarray] = None       # REQUEST / REPLY payload
    message: str = ""                        # ERROR payload
    arrays: Optional[Dict[str, np.ndarray]] = field(default=None)  # TRAJ
    traj_batch: Optional[List[Dict[str, np.ndarray]]] = None  # TRAJ_BATCH
    codecs: int = 0                          # HELLO capability bitmask
    shm: Optional[dict] = None               # SHM ring names + geometry

    @property
    def scalar(self) -> bool:
        return bool(self.flags & FLAG_SCALAR)


def parts_len(parts: Sequence) -> int:
    """Total byte length of a scatter-gather parts list."""
    return sum(p.nbytes if isinstance(p, memoryview) else len(p)
               for p in parts)


# ------------------------------------------------------------------- RLE

def rle_encode_u8(data: np.ndarray) -> bytes:
    """Run-length encode a flat uint8 array as (count u8, value u8) pairs,
    count in [1, 255] (longer runs split). Pure numpy, no pickle."""
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    if data.size == 0:
        return b""
    bounds = np.flatnonzero(data[1:] != data[:-1]) + 1
    starts = np.concatenate([[0], bounds])
    lengths = np.diff(np.concatenate([starts, [data.size]]))
    values = data[starts]
    reps = (lengths + 254) // 255              # pairs emitted per run
    out_vals = np.repeat(values, reps)
    out_lens = np.full(out_vals.size, 255, np.int64)
    out_lens[np.cumsum(reps) - 1] = lengths - (reps - 1) * 255  # in [1,255]
    pairs = np.empty((out_vals.size, 2), np.uint8)
    pairs[:, 0] = out_lens
    pairs[:, 1] = out_vals
    return pairs.tobytes()


def rle_decode_u8(buf, expected: int) -> np.ndarray:
    """Inverse of `rle_encode_u8`; `expected` is the element count the
    frame's shape prologue promises. The run total is checked BEFORE
    `np.repeat`, so a hostile stream cannot expand past the shape it
    declared (and the shape itself is capped by the caller)."""
    pairs = np.frombuffer(buf, np.uint8)
    if pairs.size % 2:
        raise CodecError("RLE payload has an odd byte count")
    counts = pairs[0::2].astype(np.int64)
    if counts.size and int(counts.min()) == 0:
        raise CodecError("zero-length RLE run")
    if int(counts.sum()) != expected:
        raise CodecError(
            f"RLE runs expand to {int(counts.sum())} bytes; shape "
            f"promised {expected}")
    return np.repeat(pairs[1::2], counts)


# ---------------------------------------------------------------- encoding

def _byte_view(arr: np.ndarray) -> memoryview:
    """Flat byte view over a C-contiguous array — NO copy (the view keeps
    the array alive for the duration of the scatter-gather send). This is
    the fix for the old ``arr.tobytes()`` copy; 0-d arrays cast cleanly
    (the old ``ascontiguousarray`` 0-d promotion hazard stays regression-
    tested in test_transport)."""
    if arr.nbytes == 0:
        return memoryview(b"")     # 0-in-shape views cannot be cast
    return memoryview(arr).cast("B")


def _quantize_f32(arr: np.ndarray, quant: str):
    """Quantized payload for a float32 array under the only-when-smaller
    (and only-when-representable) discipline. Returns (enc, payload_bytes,
    prologue_extra) or None when quantization does not apply: non-finite
    values, f16 overflow, or no size win."""
    if arr.dtype != np.float32 or arr.size == 0:
        return None
    finite = np.isfinite(arr)
    if not finite.all():
        return None                    # inf/nan: raw keeps them exact
    if quant == "f16":
        if float(np.abs(arr).max()) > _F16_MAX:
            return None                # would overflow to inf
        data = arr.astype(np.float16)
        if data.nbytes >= arr.nbytes:  # size 0 handled above; always true
            return None
        return ENC_F16, _byte_view(data), b""
    if quant == "q8":
        lo = float(arr.min())
        hi = float(arr.max())
        scale = (hi - lo) / 255.0
        extra = _Q8PARAMS.pack(scale, lo)
        if arr.size + len(extra) >= arr.nbytes:
            return None                # tiny arrays: prologue eats the win
        if scale == 0.0:
            q = np.zeros(arr.shape, np.uint8)
        else:
            q = np.clip(np.rint((arr - lo) / scale), 0, 255).astype(np.uint8)
        return ENC_Q8, _byte_view(q), extra
    raise CodecError(f"unknown quant mode {quant!r}; use 'f16' or 'q8'")


def _encode_ndarray_parts(arr: np.ndarray, compress: bool = False,
                          quant: Optional[str] = None
                          ) -> Tuple[int, List]:
    """Scatter-gather ndarray framing: (flag_bits, [prologue, payload]).

    The payload is a memoryview over the source (or quantized/RLE temp)
    buffer — callers hand the parts straight to ``sendmsg`` or a shm-ring
    write; nothing is concatenated here. ``compress``/``quant`` opt the
    array into ENC_RLE / ENC_F16 / ENC_Q8 under the only-when-smaller
    rule; the returned flag bits record what was chosen."""
    arr = np.asarray(arr)
    if arr.dtype.hasobject:
        raise CodecError(
            f"dtype {arr.dtype} is not wire-safe (object arrays would need "
            f"pickle, which the hot path forbids)")
    if not arr.flags["C_CONTIGUOUS"]:
        # ascontiguousarray would also promote 0-d to 1-d, so only call it
        # when a copy is actually needed
        arr = np.ascontiguousarray(arr)
    enc, data, extra = ENC_RAW, None, b""
    if quant is not None:
        out = _quantize_f32(arr, quant)
        if out is not None:
            enc, data, extra = out
    if enc == ENC_RAW and compress and arr.dtype == np.uint8 and arr.size:
        rle = rle_encode_u8(arr)
        if len(rle) < arr.nbytes:
            enc, data = ENC_RLE, rle
    if data is None:
        data = _byte_view(arr)
    nbytes = data.nbytes if isinstance(data, memoryview) else len(data)
    dt = arr.dtype.str.encode("ascii")
    prologue = b"".join(
        [_U8.pack(enc), _U8.pack(len(dt)), dt, _U8.pack(arr.ndim)]
        + [_U32.pack(d) for d in arr.shape]
        + [extra, _U64.pack(nbytes)])
    return _ENC_FLAG.get(enc, 0), [prologue, data]


def _encode_ndarray(arr: np.ndarray) -> bytes:
    _, parts = _encode_ndarray_parts(arr)
    return b"".join(parts)


def _frame_parts(kind: int, actor_id: int, request_id: int, flags: int,
                 payload_parts: List, param_version: int = 0,
                 trace_seq: int = 0) -> List:
    body_len = _HEADER.size + parts_len(payload_parts)
    head = _LEN.pack(body_len) + _HEADER.pack(
        MAGIC, VERSION, kind, flags, actor_id, request_id,
        param_version & 0xFFFFFFFF, trace_seq & 0xFFFFFFFF)
    return [head] + payload_parts


def _frame(kind: int, actor_id: int, request_id: int, flags: int,
           payload: bytes, param_version: int = 0,
           trace_seq: int = 0) -> bytes:
    return b"".join(_frame_parts(kind, actor_id, request_id, flags,
                                 [payload], param_version, trace_seq))


def encode_request_parts(actor_id: int, request_id: int, obs: np.ndarray,
                         scalar: bool = False, compress: bool = False,
                         quant: Optional[str] = None,
                         trace_seq: int = 0) -> List:
    """``compress``/``quant`` opt this frame into RLE / F16 / Q8 payloads —
    callers must only pass them after a HELLO negotiation granted
    ``CODEC_RLE`` / ``CODEC_QUANT`` (see `repro_torch.transport.socket`).
    ``trace_seq`` (wire v3) stitches this request's spans across
    processes; 0 means untraced."""
    flags = FLAG_SCALAR if scalar else 0
    enc_flags, parts = _encode_ndarray_parts(obs, compress=compress,
                                             quant=quant)
    return _frame_parts(KIND_REQUEST, actor_id, request_id,
                        flags | enc_flags, parts, trace_seq=trace_seq)


def encode_request(actor_id: int, request_id: int, obs: np.ndarray,
                   scalar: bool = False, compress: bool = False,
                   quant: Optional[str] = None, trace_seq: int = 0) -> bytes:
    return b"".join(encode_request_parts(actor_id, request_id, obs,
                                         scalar=scalar, compress=compress,
                                         quant=quant, trace_seq=trace_seq))


def encode_hello(codecs: int) -> bytes:
    """Connection-level capability advertisement (codec bitmask)."""
    return _frame(KIND_HELLO, 0, 0, 0, _U32.pack(codecs & 0xFFFFFFFF))


def encode_shm(c2s_name: str, s2c_name: str, slot_size: int,
               num_slots: int) -> bytes:
    """Ring attachment: the client-created shared-memory segment names and
    their (identical) slot geometry. Strictly client -> gateway, after a
    ``CODEC_SHM`` grant."""
    parts = []
    for name in (c2s_name, s2c_name):
        nb = name.encode("utf-8")
        if not 1 <= len(nb) <= 255:
            raise CodecError(f"bad shm segment name {name!r}")
        parts.append(_U8.pack(len(nb)))
        parts.append(nb)
    parts.append(_U32.pack(slot_size))
    parts.append(_U32.pack(num_slots))
    return _frame(KIND_SHM, 0, 0, 0, b"".join(parts))


def encode_reply_parts(request_id: int, actions: np.ndarray,
                       version: int = 0, trace_seq: int = 0) -> List:
    """``version`` (the behavior-param version serving this reply) rides
    the header's dedicated ``param_version`` field (wire v2; v1 smuggled
    it through the unused actor_id slot). ``trace_seq`` echoes the
    REQUEST's id so the reply leg stitches onto the same flow."""
    _, parts = _encode_ndarray_parts(actions)
    return _frame_parts(KIND_REPLY, 0, request_id, 0, parts,
                        param_version=version, trace_seq=trace_seq)


def encode_reply(request_id: int, actions: np.ndarray,
                 version: int = 0, trace_seq: int = 0) -> bytes:
    return b"".join(encode_reply_parts(request_id, actions, version=version,
                                       trace_seq=trace_seq))


def encode_error(request_id: int, message: str) -> bytes:
    """request_id == 0 broadcasts: every pending request on the connection
    fails (used for server death / shutdown)."""
    return _frame(KIND_ERROR, 0, request_id, 0, message.encode("utf-8"))


def _traj_payload_parts(arrays: Dict[str, np.ndarray], compress: bool,
                        quant: Optional[str]) -> Tuple[int, List]:
    """(flag_bits, parts) for one trajectory dict. Quantization applies
    only to the observation tensor: rewards / logprobs / versions feed the
    loss directly, so they stay exact even under CODEC_QUANT."""
    flags = 0
    parts = [_U16.pack(len(arrays))]
    for name, arr in arrays.items():
        nb = name.encode("utf-8")
        if len(nb) > 255:
            raise CodecError(f"trajectory key too long: {name!r}")
        parts.append(_U8.pack(len(nb)))
        parts.append(nb)
        f, aparts = _encode_ndarray_parts(
            np.asarray(arr), compress=compress,
            quant=quant if name == "obs" else None)
        flags |= f
        parts.extend(aparts)
    return flags, parts


def encode_trajectory_parts(actor_id: int, arrays: Dict[str, np.ndarray],
                            compress: bool = False,
                            quant: Optional[str] = None,
                            trace_seq: int = 0) -> List:
    flags, parts = _traj_payload_parts(arrays, compress, quant)
    return _frame_parts(KIND_TRAJ, actor_id, 0, flags, parts,
                        trace_seq=trace_seq)


def encode_trajectory(actor_id: int, arrays: Dict[str, np.ndarray],
                      compress: bool = False,
                      quant: Optional[str] = None,
                      trace_seq: int = 0) -> bytes:
    return b"".join(encode_trajectory_parts(actor_id, arrays,
                                            compress=compress, quant=quant,
                                            trace_seq=trace_seq))


def encode_traj_batch_parts(actor_id: int,
                            trajs: Sequence[Dict[str, np.ndarray]],
                            compress: bool = False,
                            quant: Optional[str] = None,
                            trace_seq: int = 0) -> List:
    """Coalesce several unroll dicts into ONE ``KIND_TRAJ_BATCH`` frame —
    one syscall / ring slot per actor flush instead of one per lane record.
    Only sent after a ``CODEC_TRAJBATCH`` HELLO grant."""
    if not 1 <= len(trajs) <= 0xFFFF:
        raise CodecError(f"trajectory batch of {len(trajs)} records")
    flags = 0
    parts = [_U16.pack(len(trajs))]
    for arrays in trajs:
        f, tparts = _traj_payload_parts(arrays, compress, quant)
        flags |= f
        parts.extend(tparts)
    return _frame_parts(KIND_TRAJ_BATCH, actor_id, 0, flags, parts,
                        trace_seq=trace_seq)


def encode_traj_batch(actor_id: int, trajs: Sequence[Dict[str, np.ndarray]],
                      compress: bool = False,
                      quant: Optional[str] = None,
                      trace_seq: int = 0) -> bytes:
    return b"".join(encode_traj_batch_parts(actor_id, trajs,
                                            compress=compress, quant=quant,
                                            trace_seq=trace_seq))


# ---------------------------------------------------------------- decoding

def _need(body, offset: int, n: int) -> int:
    if offset + n > len(body):
        raise TruncatedFrame(
            f"frame body ended at {len(body)} bytes; needed {offset + n}")
    return offset + n


def _view_or_copy(body, offset: int, nbytes: int, dtype, shape,
                  zero_copy: bool) -> np.ndarray:
    """Raw payload -> ndarray. With ``zero_copy`` the result is a read-only
    view over ``body`` when the element alignment works out (the view
    keeps the body alive); otherwise — and always without ``zero_copy`` —
    a detached copy."""
    if zero_copy:
        raw = np.frombuffer(body, np.uint8, count=nbytes, offset=offset)
        if raw.__array_interface__["data"][0] % dtype.alignment == 0:
            return raw.view(dtype).reshape(shape)
        return raw.view(np.uint8).copy().view(dtype).reshape(shape)
    return np.frombuffer(body, dtype=dtype, count=nbytes // dtype.itemsize
                         if dtype.itemsize else 0,
                         offset=offset).reshape(shape).copy()


def _decode_ndarray(body, offset: int, max_frame: int = DEFAULT_MAX_FRAME,
                    zero_copy: bool = False):
    end = _need(body, offset, 2)
    (enc,) = _U8.unpack_from(body, offset)
    (dlen,) = _U8.unpack_from(body, offset + 1)
    offset = end
    end = _need(body, offset, dlen)
    try:
        dtype = np.dtype(bytes(body[offset:end]).decode("ascii"))
    except (TypeError, UnicodeDecodeError) as e:
        raise CodecError(f"bad dtype string: {e}") from None
    if dtype.hasobject:
        raise CodecError("refusing object dtype from the wire")
    offset = end
    end = _need(body, offset, 1)
    (ndim,) = _U8.unpack_from(body, offset)
    offset = end
    shape = []
    for _ in range(ndim):
        end = _need(body, offset, 4)
        shape.append(_U32.unpack_from(body, offset)[0])
        offset = end
    scale = offset_val = 0.0
    if enc == ENC_Q8:
        end = _need(body, offset, _Q8PARAMS.size)
        scale, offset_val = _Q8PARAMS.unpack_from(body, offset)
        offset = end
    end = _need(body, offset, 8)
    (nbytes,) = _U64.unpack_from(body, offset)
    offset = end
    # arbitrary-precision product: a hostile shape like (2^31, 2^31, 4)
    # must not wrap to a small number and slip past the length check
    count = 1
    for d in shape:
        count *= d
    expected = dtype.itemsize * count
    if enc == ENC_RAW:
        if nbytes != expected:
            raise CodecError(
                f"ndarray length mismatch: header says {nbytes} bytes, "
                f"shape {tuple(shape)} x {dtype} needs {expected}")
        end = _need(body, offset, nbytes)
        return _view_or_copy(body, offset, nbytes, dtype, shape,
                             zero_copy), end
    # every compressed/quantized encoding expands: cap the expansion target
    # (from the declared shape) at the same max_frame bound the raw path
    # enforces via its length prefix, BEFORE any allocation
    if expected > max_frame:
        name = {ENC_RLE: "RLE", ENC_F16: "F16", ENC_Q8: "Q8"}.get(
            enc, f"enc={enc}")
        raise CodecError(
            f"{name} expansion to {expected} bytes exceeds "
            f"max_frame={max_frame}")
    if enc == ENC_RLE:
        if dtype != np.dtype(np.uint8):
            raise CodecError(f"ENC_RLE only covers uint8, got {dtype}")
        end = _need(body, offset, nbytes)
        arr = rle_decode_u8(body[offset:end], count).reshape(shape)
        return arr, end          # np.repeat already owns fresh memory
    if enc == ENC_F16:
        if dtype != np.dtype(np.float32):
            raise CodecError(f"ENC_F16 only covers float32, got {dtype}")
        if nbytes != 2 * count:
            raise CodecError(
                f"ENC_F16 length mismatch: {nbytes} bytes for {count} "
                f"elements")
        end = _need(body, offset, nbytes)
        half = np.frombuffer(body, np.uint8, count=nbytes,
                             offset=offset).view(np.uint8).copy()
        return half.view(np.float16).astype(np.float32).reshape(shape), end
    if enc == ENC_Q8:
        if dtype != np.dtype(np.float32):
            raise CodecError(f"ENC_Q8 only covers float32, got {dtype}")
        if nbytes != count:
            raise CodecError(
                f"ENC_Q8 length mismatch: {nbytes} bytes for {count} "
                f"elements")
        if not (np.isfinite(scale) and np.isfinite(offset_val)):
            raise CodecError("non-finite Q8 scale/offset")
        end = _need(body, offset, nbytes)
        q = np.frombuffer(body, np.uint8, count=nbytes, offset=offset)
        arr = (q.astype(np.float32) * np.float32(scale)
               + np.float32(offset_val)).reshape(shape)
        return arr, end
    raise CodecError(f"unknown ndarray encoding {enc}")


def _decode_traj(body, offset: int, max_frame: int, zero_copy: bool):
    end = _need(body, offset, 2)
    (count,) = _U16.unpack_from(body, offset)
    offset = end
    arrays = {}
    for _ in range(count):
        end = _need(body, offset, 1)
        (nlen,) = _U8.unpack_from(body, offset)
        offset = end
        end = _need(body, offset, nlen)
        try:
            name = bytes(body[offset:end]).decode("utf-8")
        except UnicodeDecodeError as e:
            # must surface as CodecError: the gateway reader only
            # treats (OSError, CodecError) as connection failures
            raise CodecError(f"bad trajectory key: {e}") from None
        offset = end
        arrays[name], offset = _decode_ndarray(body, offset,
                                               max_frame=max_frame,
                                               zero_copy=zero_copy)
    return arrays, offset


def decode_frame(body, max_frame: int = DEFAULT_MAX_FRAME,
                 zero_copy: bool = False) -> Frame:
    """Decode one frame body (length prefix already stripped).
    `max_frame` bounds compressed-payload expansion — pass the same limit
    the stream reader enforces on raw frames. With ``zero_copy`` the
    returned arrays may be read-only views over ``body`` (which they keep
    alive); only pass it for buffers that are never mutated afterwards."""
    if len(body) < _HEADER.size:
        raise TruncatedFrame(f"frame body of {len(body)} bytes < header")
    (magic, ver, kind, flags, actor_id, request_id,
     param_version, trace_seq) = _HEADER.unpack_from(body)
    if magic != MAGIC:
        raise CodecError(f"bad magic 0x{magic:04x} (stream desynchronized?)")
    if ver != VERSION:
        raise CodecError(
            f"wire version {ver} peer, this end speaks {VERSION} — "
            f"upgrade both ends (capability interop WITHIN a version is "
            f"negotiated by HELLO, across versions is not)")
    if flags & ~_KNOWN_FLAGS:
        # reject BEFORE touching the payload: an unknown flag means we
        # cannot know how the bytes are encoded, so allocating from them
        # would be garbage at best and a decompression bomb at worst
        raise CodecError(f"unknown flag bits 0x{flags & ~_KNOWN_FLAGS:02x}")
    if flags & _ARRAY_FLAGS and kind in (KIND_ERROR, KIND_HELLO, KIND_SHM):
        raise CodecError(
            f"array-encoding flags 0x{flags & _ARRAY_FLAGS:02x} are "
            f"invalid on frame kind {kind}")
    offset = _HEADER.size
    frame = Frame(kind=kind, actor_id=actor_id, request_id=request_id,
                  flags=flags, param_version=param_version,
                  trace_seq=trace_seq)
    if kind in (KIND_REQUEST, KIND_REPLY):
        frame.array, offset = _decode_ndarray(body, offset,
                                              max_frame=max_frame,
                                              zero_copy=zero_copy)
    elif kind == KIND_HELLO:
        end = _need(body, offset, 4)
        (frame.codecs,) = _U32.unpack_from(body, offset)
        offset = end
    elif kind == KIND_ERROR:
        frame.message = bytes(body[offset:]).decode("utf-8",
                                                    errors="replace")
        offset = len(body)
    elif kind == KIND_TRAJ:
        frame.arrays, offset = _decode_traj(body, offset, max_frame,
                                            zero_copy)
    elif kind == KIND_TRAJ_BATCH:
        end = _need(body, offset, 2)
        (n,) = _U16.unpack_from(body, offset)
        offset = end
        batch = []
        for _ in range(n):
            arrays, offset = _decode_traj(body, offset, max_frame,
                                          zero_copy)
            batch.append(arrays)
        frame.traj_batch = batch
    elif kind == KIND_SHM:
        names = []
        for _ in range(2):
            end = _need(body, offset, 1)
            (nlen,) = _U8.unpack_from(body, offset)
            offset = end
            end = _need(body, offset, nlen)
            try:
                names.append(bytes(body[offset:end]).decode("utf-8"))
            except UnicodeDecodeError as e:
                raise CodecError(f"bad shm segment name: {e}") from None
            offset = end
        end = _need(body, offset, 8)
        (slot_size,) = _U32.unpack_from(body, offset)
        (num_slots,) = _U32.unpack_from(body, offset + 4)
        offset = end
        frame.shm = {"c2s": names[0], "s2c": names[1],
                     "slot_size": slot_size, "num_slots": num_slots}
    else:
        raise CodecError(f"unknown frame kind {kind}")
    if offset != len(body):
        raise CodecError(
            f"{len(body) - offset} trailing bytes after frame payload")
    return frame


def read_frame(read_exact: Callable[[int], bytes],
               max_frame: int = DEFAULT_MAX_FRAME,
               zero_copy: bool = False) -> Optional[Frame]:
    """Read one frame from a stream.

    ``read_exact(n)`` must return exactly n bytes, b"" on clean EOF, and may
    raise OSError. Returns None on clean EOF at a frame boundary; raises
    TruncatedFrame if the stream dies mid-frame, FrameTooLarge before
    reading an oversized body.
    """
    prefix = read_exact(_LEN.size)
    if prefix == b"":
        return None
    if len(prefix) < _LEN.size:
        raise TruncatedFrame("EOF inside length prefix")
    (body_len,) = _LEN.unpack(prefix)
    if body_len > max_frame:
        raise FrameTooLarge(
            f"frame of {body_len} bytes exceeds max_frame={max_frame}")
    body = read_exact(body_len)
    if len(body) < body_len:
        raise TruncatedFrame(
            f"EOF after {len(body)}/{body_len} body bytes")
    return decode_frame(body, max_frame=max_frame, zero_copy=zero_copy)


def recv_exact(sock, n: int) -> bytes:
    """Socket adapter for ``read_frame``: exactly n bytes or b"" iff the
    peer closed before the first byte; short reads mid-buffer return what
    arrived (the caller raises TruncatedFrame)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
