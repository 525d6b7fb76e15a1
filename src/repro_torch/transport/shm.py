"""Shared-memory ring transport: the co-located wire without syscalls.

A copy of ``repro.transport.shm`` (standard library only), with the
same segment layout.

The paper's fig. 4 story is that the actor->inference hot path is bounded
by CPU-side work, and on a single host a TCP loopback frame pays for a
lot of CPU that carries no information: two kernel crossings per send,
reader-thread wakeups on both ends, and at least one concat copy. SRL
(Mei et al. 2023) makes the same observation at ten-thousand-core scale
and gives co-located workers a shared-memory data plane; this module is
that plane for our single-host deployments.

`ShmRing` is a fixed-capacity single-producer/single-consumer ring over
one `multiprocessing.shared_memory` segment, in the fixed-slot style of
machin's buffer layout: ``num_slots`` slots of ``slot_size`` payload
bytes each, a frame per slot. Publication is seqlock-flavored: the writer
fills the slot payload, then its length, and LAST stamps the slot with
``seq + 1`` — the reader trusts a slot only once the stamp equals its own
``tail + 1``, copies the payload out, and only then publishes the new
tail (releasing the slot for reuse). Counters are monotonic u64 sequence
numbers, so ``head - tail`` is the fill level and wraparound is just
``seq % num_slots``. One cache line (64 B) per shared counter keeps the
writer's and reader's stores off each other's lines. CPython's GIL plus
x86-TSO store ordering make the two plain u64 stores on each side safe
for this protocol; a `threading.Lock` serializes in-process producers
(e.g. several replica reply threads writing one client's s2c ring).

Deployment shape (see `repro_torch.transport.socket` for the negotiation):

  * the client offers ``CODEC_SHM`` in HELLO only when dialing a loopback
    address; the gateway grants it only for loopback peers;
  * on grant the CLIENT creates two rings — c2s (requests + trajectories)
    and s2c (replies) — and announces their names + geometry in one
    ``KIND_SHM`` frame over TCP;
  * from then on frames ride the rings; the TCP connection stays open as
    the control, spill, and liveness channel. A frame that does not fit a
    slot, or arrives while the ring is full, spills to TCP (the codec is
    identical on both paths, so ordering metadata survives);
  * either side dying is detected on the TCP socket (EOF / ECONNRESET),
    which severs the connection exactly like the plain socket transport —
    the rings never hold liveness state.

The ring carries whole wire frames (length prefix included) so the TCP
and shm paths share one codec and one frame ledger.
"""

import struct
import threading
from multiprocessing import shared_memory
from typing import List, Optional

from repro_torch.transport.codec import parts_len

RING_MAGIC = 0x53524E47                # "SRNG"
RING_VERSION = 1

# hard caps on wire-advertised geometry: an attach request can never make
# us map more than ~64 MiB * 4096 slots no matter what the frame says
MAX_SLOT_SIZE = 64 << 20
MAX_NUM_SLOTS = 4096

DEFAULT_SLOT_SIZE = 1 << 20            # 1 MiB: any sane lane batch fits
DEFAULT_NUM_SLOTS = 64

_HEAD_OFF = 0                          # u64, writer-published (informative)
_TAIL_OFF = 64                         # u64, reader-published (flow control)
_GEOM_OFF = 128                        # u32 magic | u32 ver | u32 slot | u32 n
_HDR_SIZE = 192
_SLOT_HDR = 16                         # u64 stamp | u32 length | u32 pad
_GEOM = struct.Struct("<IIII")
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


class ShmRingError(RuntimeError):
    """Corrupt or incompatible ring segment."""


class ShmRing:
    """Fixed-slot SPSC frame ring over one shared-memory segment.

    One side calls `create` (and later `unlink`), the other `attach` with
    the geometry it was told on the wire — `attach` cross-checks it
    against the geometry stamped into the segment, so a desynchronized
    peer fails loudly instead of reading garbage slots.
    """

    def __init__(self, shm_seg, slot_size: int, num_slots: int,
                 owner: bool):
        self._shm = shm_seg
        self._buf = shm_seg.buf
        self.slot_size = slot_size
        self.num_slots = num_slots
        self._stride = _SLOT_HDR + slot_size
        self._owner = owner
        self._head = 0                 # writer-local next sequence
        self._tail = 0                 # reader-local next sequence
        self._lock = threading.Lock()  # in-process multi-producer guard
        self._closed = False

    # -------------------------------------------------------- lifecycle

    @classmethod
    def create(cls, slot_size: int = DEFAULT_SLOT_SIZE,
               num_slots: int = DEFAULT_NUM_SLOTS) -> "ShmRing":
        cls._check_geometry(slot_size, num_slots)
        size = _HDR_SIZE + num_slots * (_SLOT_HDR + slot_size)
        seg = shared_memory.SharedMemory(create=True, size=size)
        # fresh segments are zero-filled on Linux; stamp the geometry so
        # attach() can verify the peer and we agree on the layout
        _GEOM.pack_into(seg.buf, _GEOM_OFF, RING_MAGIC, RING_VERSION,
                        slot_size, num_slots)
        return cls(seg, slot_size, num_slots, owner=True)

    @classmethod
    def attach(cls, name: str, slot_size: int, num_slots: int) -> "ShmRing":
        cls._check_geometry(slot_size, num_slots)
        # NOTE on resource_tracker: pre-3.12 registers attaches too, but
        # the tracker cache is a set shared across the spawn tree (the fd
        # is inherited), so create + attach + one unlink stay balanced —
        # unregistering here would make the creator's unlink double-free
        # the cache entry and spam tracker tracebacks
        seg = shared_memory.SharedMemory(name=name)
        try:
            magic, ver, got_slot, got_n = _GEOM.unpack_from(seg.buf,
                                                            _GEOM_OFF)
            if magic != RING_MAGIC or ver != RING_VERSION:
                raise ShmRingError(
                    f"segment {name!r} is not a v{RING_VERSION} ring "
                    f"(magic 0x{magic:08x}, ver {ver})")
            if (got_slot, got_n) != (slot_size, num_slots):
                raise ShmRingError(
                    f"ring geometry mismatch: wire said "
                    f"{slot_size}x{num_slots}, segment says "
                    f"{got_slot}x{got_n}")
            need = _HDR_SIZE + num_slots * (_SLOT_HDR + slot_size)
            if seg.size < need:
                raise ShmRingError(
                    f"segment of {seg.size} bytes too small for declared "
                    f"geometry ({need} bytes)")
        except Exception:
            seg.close()
            raise
        return cls(seg, slot_size, num_slots, owner=False)

    @staticmethod
    def _check_geometry(slot_size: int, num_slots: int):
        if not 1 <= slot_size <= MAX_SLOT_SIZE:
            raise ShmRingError(f"slot_size {slot_size} out of "
                               f"[1, {MAX_SLOT_SIZE}]")
        if not 1 <= num_slots <= MAX_NUM_SLOTS:
            raise ShmRingError(f"num_slots {num_slots} out of "
                               f"[1, {MAX_NUM_SLOTS}]")

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self):
        """Drop this side's mapping. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._buf = None               # release exported memoryview first
        self._shm.close()

    def unlink(self):
        """Remove the segment from /dev/shm (creator side). Idempotent."""
        self.close()
        if self._owner:
            self._owner = False
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass

    # ------------------------------------------------------------- data

    def try_put(self, parts: List) -> bool:
        """Copy one frame (a scatter-gather parts list) into the next
        slot. Returns False — caller spills to TCP — when the frame
        exceeds the slot payload or the ring is full."""
        total = parts_len(parts)
        if total > self.slot_size:
            return False
        with self._lock:
            if self._closed:
                return False
            head = self._head
            (tail,) = _U64.unpack_from(self._buf, _TAIL_OFF)
            if head - tail >= self.num_slots:
                return False
            base = _HDR_SIZE + (head % self.num_slots) * self._stride
            off = base + _SLOT_HDR
            for p in parts:
                n = p.nbytes if isinstance(p, memoryview) else len(p)
                self._buf[off:off + n] = p
                off += n
            _U32.pack_into(self._buf, base + 8, total)
            # the stamp is the publication barrier: payload + length are
            # in place before the reader can match stamp == tail + 1
            _U64.pack_into(self._buf, base, head + 1)
            self._head = head + 1
            _U64.pack_into(self._buf, _HEAD_OFF, head + 1)
        return True

    def try_get(self) -> Optional[bytes]:
        """Pop the next frame's wire bytes, or None when the ring is
        empty. The payload is copied out BEFORE the tail is published, so
        the writer can never overwrite a slot still being read."""
        if self._closed:
            return None
        tail = self._tail
        base = _HDR_SIZE + (tail % self.num_slots) * self._stride
        (stamp,) = _U64.unpack_from(self._buf, base)
        if stamp != tail + 1:
            return None
        (length,) = _U32.unpack_from(self._buf, base + 8)
        if length > self.slot_size:
            raise ShmRingError(
                f"slot {tail % self.num_slots} claims {length} bytes "
                f"(> slot_size {self.slot_size}): ring corrupt")
        payload = bytes(self._buf[base + _SLOT_HDR:
                                  base + _SLOT_HDR + length])
        self._tail = tail + 1
        _U64.pack_into(self._buf, _TAIL_OFF, tail + 1)
        return payload

    def fill(self) -> int:
        """Frames currently in flight (writer view)."""
        (tail,) = _U64.unpack_from(self._buf, _TAIL_OFF)
        return self._head - tail
