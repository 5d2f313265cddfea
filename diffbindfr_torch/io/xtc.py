"""GROMACS XTC trajectory writer and reader (pure Python): the port's copy
of diffbindfr_tpu/io/xtc.py, byte for byte the same output.

XDR framing and the libxdrf 3dfcoord compressed coordinate codec (magicints
table, big-number base encoding, MSB-first bit packing). After every
full-size atom the bitstream carries a 1-bit flag for the codec's run-length
"small diff" mode; this writer always emits 0 (every atom full-size), which
any conforming decoder reads exactly. The reader decodes the run mode too,
so files from GROMACS tools parse. Coordinates are stored in nm at the
given precision (GROMACS convention); writer and reader convert from and to
Angstrom.
"""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = 1995
_MAGICINTS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625,
    2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642,
    26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140,
    208063, 262144, 330280, 416127, 524287, 660561, 832255, 1048576,
    1321122, 1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042,
    8388607, 10568983, 13316085, 16777216,
]
_FIRSTIDX = 9


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.lastbits = 0
        self.lastbyte = 0

    def send(self, num_of_bits: int, num: int):
        num &= (1 << num_of_bits) - 1 if num_of_bits < 64 else ~0
        while num_of_bits >= 8:
            self.lastbyte = ((self.lastbyte << 8)
                             | ((num >> (num_of_bits - 8)) & 0xFF))
            self.bytes.append((self.lastbyte >> self.lastbits) & 0xFF)
            num_of_bits -= 8
        if num_of_bits > 0:
            self.lastbyte = ((self.lastbyte << num_of_bits)
                             | (num & ((1 << num_of_bits) - 1)))
            self.lastbits += num_of_bits
            if self.lastbits >= 8:
                self.lastbits -= 8
                self.bytes.append((self.lastbyte >> self.lastbits) & 0xFF)

    def finish(self) -> bytes:
        out = bytes(self.bytes)
        if self.lastbits > 0:
            out += bytes([(self.lastbyte << (8 - self.lastbits)) & 0xFF])
        return out


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def receive(self, num_of_bits: int) -> int:
        num = 0
        while num_of_bits >= 8:
            self.lastbyte = (
                (self.lastbyte << 8) | self.data[self.cnt]
            ) & 0xFFFFFF
            self.cnt += 1
            num |= ((self.lastbyte >> self.lastbits) & 0xFF) << (
                num_of_bits - 8
            )
            num_of_bits -= 8
        if num_of_bits > 0:
            if self.lastbits < num_of_bits:
                self.lastbits += 8
                self.lastbyte = (
                    (self.lastbyte << 8) | self.data[self.cnt]
                ) & 0xFFFFFF
                self.cnt += 1
            self.lastbits -= num_of_bits
            num |= (self.lastbyte >> self.lastbits) & ((1 << num_of_bits) - 1)
        return num


def _sizeofint(size: int) -> int:
    # libxdrf semantics: smallest bits with (1 << bits) > size (strictly
    # greater), so exact powers of two still get one extra bit — required
    # for GROMACS interop on the large-range path
    bits = 0
    while (1 << bits) <= size:
        bits += 1
    return bits


def _sizeofints(sizes) -> int:
    """Bits for the mixed-radix big number over `sizes` (byte-array
    arithmetic mirrors libxdrf so the bit count matches exactly)."""
    arr = [1]
    for s in sizes:
        carry = 0
        out = []
        for byte in arr:
            v = byte * int(s) + carry
            out.append(v & 0xFF)
            carry = v >> 8
        while carry:
            out.append(carry & 0xFF)
            carry >>= 8
        arr = out
    nbits = 0
    top = arr[-1]
    num = 1
    while top >= num:
        nbits += 1
        num *= 2
    return nbits + (len(arr) - 1) * 8


def _encodeints(bw: _BitWriter, num_of_bits: int, sizes, nums):
    arr = [int(nums[0]) & 0xFF]
    t = int(nums[0]) >> 8
    while t:
        arr.append(t & 0xFF)
        t >>= 8
    for i in range(1, len(nums)):
        carry = int(nums[i])
        out = []
        for byte in arr:
            v = byte * int(sizes[i]) + carry
            out.append(v & 0xFF)
            carry = v >> 8
        while carry:
            out.append(carry & 0xFF)
            carry >>= 8
        arr = out
    if num_of_bits >= len(arr) * 8:
        for byte in arr:
            bw.send(8, byte)
        bw.send(num_of_bits - len(arr) * 8, 0)
    else:
        for byte in arr[:-1]:
            bw.send(8, byte)
        bw.send(num_of_bits - (len(arr) - 1) * 8, arr[-1])


def _decodeints(br: _BitReader, num_of_bits: int, sizes):
    arr = []
    nb = num_of_bits
    while nb > 8:
        arr.append(br.receive(8))
        nb -= 8
    if nb > 0:
        arr.append(br.receive(nb))
    nums = [0, 0, 0]
    for i in range(len(sizes) - 1, 0, -1):
        num = 0
        for j in range(len(arr) - 1, -1, -1):
            num = (num << 8) | arr[j]
            p = num // int(sizes[i])
            arr[j] = p
            num -= p * int(sizes[i])
        nums[i] = num
    v = 0
    for j in range(min(len(arr), 8) - 1, -1, -1):
        v = (v << 8) | arr[j]
    nums[0] = v
    return nums


def write_xtc(path: str, coords: np.ndarray, *, time_ps: np.ndarray | None
              = None, precision: float = 1000.0, units: str = "angstrom",
              box: np.ndarray | None = None):
    """coords [F, N, 3]; Angstrom by default (converted to the nm the
    format stores). box [3, 3] nm or None (zero box)."""
    coords = np.asarray(coords, np.float64)
    if units == "angstrom":
        coords = coords * 0.1
    elif units != "nm":
        raise ValueError(units)
    nf, natoms, _ = coords.shape
    if time_ps is None:
        time_ps = np.arange(nf, dtype=np.float64)
    if box is None:
        box = np.zeros((3, 3), np.float64)
    with open(path, "wb") as fh:
        for f in range(nf):
            fh.write(_frame_bytes(coords[f], natoms, f, float(time_ps[f]),
                                  box, precision))


def _frame_bytes(xyz_nm, natoms, step, time_ps, box, precision) -> bytes:
    head = struct.pack(">iiif", _MAGIC, natoms, step, time_ps)
    head += struct.pack(">9f", *np.asarray(box, np.float64).reshape(9))
    head += struct.pack(">i", natoms)
    if natoms <= 9:  # plain float path (format rule)
        return head + struct.pack(f">{natoms * 3}f",
                                  *xyz_nm.reshape(-1).astype(np.float32))
    head += struct.pack(">f", precision)
    ints = np.rint(xyz_nm * precision).astype(np.int64)
    minint = ints.min(axis=0)
    maxint = ints.max(axis=0)
    head += struct.pack(">3i", *minint)
    head += struct.pack(">3i", *maxint)
    sizeint = (maxint - minint + 1).astype(np.int64)
    if (sizeint > 0xFFFFFF).any():
        bitsizeint = [_sizeofint(int(s)) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(sizeint)
    smallidx = _FIRSTIDX
    head += struct.pack(">i", smallidx)
    bw = _BitWriter()
    rel = (ints - minint[None, :]).astype(np.int64)
    for a in range(natoms):
        if bitsize == 0:
            for j in range(3):
                bw.send(bitsizeint[j], int(rel[a, j]))
        else:
            _encodeints(bw, bitsize, sizeint, rel[a])
        bw.send(1, 0)  # flag: no small-diff run follows
    data = bw.finish()
    out = head + struct.pack(">i", len(data)) + data
    pad = (-len(data)) % 4
    return out + b"\x00" * pad


def read_xtc(path: str, units: str = "angstrom"):
    """Returns (coords [F, N, 3], time_ps [F]). Implements the full
    reference decoder including the small-diff run mode this writer never
    emits (so files from GROMACS tools also parse)."""
    frames = []
    times = []
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off < len(data):
        magic, natoms, step, t = struct.unpack_from(">iiif", data, off)
        if magic != _MAGIC:
            raise ValueError(f"bad XTC magic {magic} at offset {off}")
        off += 16
        off += 36  # box
        (lsize,) = struct.unpack_from(">i", data, off)
        off += 4
        if natoms <= 9:
            xyz = np.asarray(struct.unpack_from(f">{natoms * 3}f", data, off),
                             np.float64).reshape(natoms, 3)
            off += natoms * 12
        else:
            (precision,) = struct.unpack_from(">f", data, off)
            off += 4
            minint = struct.unpack_from(">3i", data, off)
            off += 12
            maxint = struct.unpack_from(">3i", data, off)
            off += 12
            (smallidx,) = struct.unpack_from(">i", data, off)
            off += 4
            (nbytes,) = struct.unpack_from(">i", data, off)
            off += 4
            br = _BitReader(data[off : off + nbytes])
            off += nbytes + ((-nbytes) % 4)
            sizeint = [maxint[j] - minint[j] + 1 for j in range(3)]
            if any(s > 0xFFFFFF for s in sizeint):
                bitsizeint = [_sizeofint(s) for s in sizeint]
                bitsize = 0
            else:
                bitsizeint = [0, 0, 0]
                bitsize = _sizeofints(sizeint)
            smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
            smallnum = _MAGICINTS[smallidx] // 2
            sizesmall = [_MAGICINTS[smallidx]] * 3
            xyz = np.zeros((natoms, 3), np.float64)
            w = 0
            while w < natoms:
                if bitsize == 0:
                    this = [br.receive(bitsizeint[j]) for j in range(3)]
                else:
                    this = _decodeints(br, bitsize, sizeint)
                this = [this[j] + minint[j] for j in range(3)]
                prev = list(this)
                flag = br.receive(1)
                is_smaller = 0
                run = 0
                if flag:
                    run = br.receive(5)
                    is_smaller = run % 3
                    run -= is_smaller
                    is_smaller -= 1
                if run > 0:
                    smallbits = _sizeofints(sizesmall)
                    for kk in range(0, run, 3):
                        sm = _decodeints(br, smallbits, sizesmall)
                        this = [sm[j] + prev[j] - smallnum
                                for j in range(3)]
                        if kk == 0:
                            # the codec swaps the run's first atom with
                            # its anchor (water-molecule correlation) and
                            # emits the small one first
                            this, prev = prev, this
                            xyz[w] = np.asarray(prev) / precision
                            w += 1
                        else:
                            prev = list(this)
                        if w < natoms:
                            xyz[w] = np.asarray(this) / precision
                            w += 1
                else:
                    xyz[w] = np.asarray(prev) / precision
                    w += 1
                if is_smaller < 0:
                    smallnum = smaller
                    if smallidx > _FIRSTIDX:
                        smallidx -= 1
                        smaller = _MAGICINTS[max(_FIRSTIDX,
                                                 smallidx - 1)] // 2
                    sizesmall = [_MAGICINTS[smallidx]] * 3
                elif is_smaller > 0:
                    smallidx += 1
                    smaller = smallnum
                    smallnum = _MAGICINTS[smallidx] // 2
                    sizesmall = [_MAGICINTS[smallidx]] * 3
        frames.append(xyz)
        times.append(t)
    coords = np.stack(frames)
    if units == "angstrom":
        coords = coords * 10.0
    return coords, np.asarray(times)
