"""Wire-level inference transport — the gRPC-shaped seam, realized.

A copy of ``repro.transport`` with its imports taken from the port, so
that it imports nothing of the JAX package.

`core.inference` promised that its queue API was "the only seam a
networked transport would replace"; this package replaces it. Four
layers:

  * `repro_torch.transport.codec` — length-prefixed binary frames (no pickle on
    the hot path): requests, replies, errors, trajectory unrolls, batched
    unrolls, and the HELLO/SHM negotiation frames. Encoders come in two
    shapes: `encode_*` (one joined `bytes`) and `encode_*_parts`
    (zero-copy buffer-view lists for `socket.sendmsg` scatter-gather);
  * `repro_torch.transport.local.InProcTransport` — the identity transport over
    a local `InferenceServer` (the default; bit-for-bit today's behavior);
  * `repro_torch.transport.shm.ShmRing` — a fixed-capacity single-producer /
    single-consumer ring over `multiprocessing.shared_memory`, carrying
    whole wire frames between co-located processes without a syscall;
  * `repro_torch.transport.socket` — `SocketTransport` / `SyncSocketTransport`
    (actor-host clients) and `InferenceGateway` (learner-side acceptor)
    over TCP, preserving the batching deadline and per-(actor, lane)
    recurrent-slot semantics across the wire. `ShmTransport` extends the
    sync client: after HELLO grants CODEC_SHM (loopback peers only) it
    rides a ring pair and keeps TCP as the spill/control/liveness channel.

Transport decision matrix — which plane, which codec:

  placement               transport        why
  ----------------------  ---------------  --------------------------------
  actors in-process       "inproc"         no wire at all; the baseline
  co-located processes    "shm"            ring memcpy beats loopback TCP:
                                           no per-frame syscalls or reader
                                           wakeups; TCP remains for spill
  separate hosts          "socket" (tcp)   the only option once frames
                                           cross a NIC

  payload                 codec flag       discipline
  ----------------------  ---------------  --------------------------------
  uint8 observations      CODEC_RLE        lossless; only-when-smaller
  float32 observations    CODEC_QUANT f16  lossy 2x; skipped on overflow
  float32 observations    CODEC_QUANT q8   lossy 4x (affine int8 + scale/
                                           offset); only-when-smaller
  many small unrolls      CODEC_TRAJBATCH  one frame (and one syscall) per
                                           flush instead of per record

Everything is negotiated per-connection in HELLO: a client offers, the
gateway grants the intersection it supports, and un-granted codecs simply
never appear on the wire — so heterogeneous fleets mix freely.

`repro_torch.launch.actor_host` spawns OS-process actor hosts against a gateway
address; `SeedSystem(transport="socket")` or `SeedSystem(transport="shm")`
wires the whole thing together.
"""

from repro_torch.transport.codec import (CODEC_ONPOLICY, CODEC_QUANT,
                                         CODEC_RLE, CODEC_SHM, CODEC_TRAJBATCH,
                                         SUPPORTED_CODECS, CodecError, Frame,
                                         FrameTooLarge, TruncatedFrame,
                                         decode_frame, encode_error,
                                         encode_hello, encode_reply,
                                         encode_reply_parts, encode_request,
                                         encode_request_parts, encode_shm,
                                         encode_traj_batch,
                                         encode_traj_batch_parts,
                                         encode_trajectory,
                                         encode_trajectory_parts, parts_len,
                                         read_frame, rle_decode_u8,
                                         rle_encode_u8)
from repro_torch.transport.local import InProcTransport, Transport
from repro_torch.transport.shm import ShmRing, ShmRingError
from repro_torch.transport.socket import (InferenceGateway, ShmTransport,
                                          SocketTransport, SyncSocketTransport,
                                          sendmsg_all)

__all__ = [
    "CODEC_ONPOLICY", "CODEC_QUANT", "CODEC_RLE", "CODEC_SHM",
    "CODEC_TRAJBATCH", "SUPPORTED_CODECS",
    "CodecError", "Frame", "FrameTooLarge", "TruncatedFrame",
    "decode_frame", "encode_error", "encode_hello", "encode_reply",
    "encode_reply_parts", "encode_request", "encode_request_parts",
    "encode_shm", "encode_traj_batch", "encode_traj_batch_parts",
    "encode_trajectory", "encode_trajectory_parts", "parts_len",
    "read_frame", "rle_decode_u8", "rle_encode_u8",
    "InProcTransport", "Transport",
    "ShmRing", "ShmRingError",
    "InferenceGateway", "ShmTransport", "SocketTransport",
    "SyncSocketTransport", "sendmsg_all",
]
