"""Build variants of kernel B5 and time them at its gated shapes.

    python3 tools/tune_b5.py VARIANT [VARIANT ...]

A VARIANT is ``name[@dir]``: ``stream_select.cu`` of the source directory
``dir`` (default ``raft_tpu_torch/csrc``) built with the package's nvcc
flags, all variants at once into ``build/tune_b5/``. A variant is an
edited copy of the sources::

    cp -r raft_tpu_torch/csrc build/v1   # then edit build/v1/stream_select.cu
    python3 tools/tune_b5.py base v1@build/v1

A variant whose C entry has no load-width argument (the eight-pass kernel
before the threshold filter) is called without it. Each variant is first
held to the plain version, positions equal and values by bits (NaN where
NaN), on keys that take every branch: Gaussian, ties at the threshold
(8, 32, 33 keys a sub-chunk), signed zeros, constant, starved, -inf-heavy
and NaN rows, row lengths with n % 4 = 1, 2, 3 and a view one float into
its storage. Then it is timed on Gaussian keys made on the card at the
kAuto gate's shapes 1024 x 262,144, 64 x 131,072 and 8 x 65,536: median
of 11 by CUDA events, device time by ``torch.profiler``, and at 64 x
131,072 also the device time cold (a 128 MB write evicts the keys from
the 50 MB L2 before each call), beside the byte bound and the time of
``torch.amin`` over the same keys (a read-only pass, for the read rate
the card reaches). The device time at 1024 x 262,144 is also taken on
keys whose every sub-chunk takes the eight passes (constant keys, and
integers in {0, 1, 2}). The script prints ptxas'
register and spill lines of the B5 kernels and the card line.
"""
import ctypes
import json
import re
import sys

import numpy as np
import torch

from tune_common import ROOT, build, card_line, parse, time_ms

sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch.ops import _build  # noqa: E402
from raft_tpu_torch.ops import stream_select as ss  # noqa: E402

SHAPES = ((1024, 262144), (64, 131072), (8, 65536))


class _Entry:
    """A variant's library, called as the wrapper calls the tree's; the
    load-width argument is dropped for a C entry that has none."""

    def __init__(self, path, src):
        self.lib = ctypes.CDLL(str(path))
        proto = re.search(r"int stream_extract_launch\(([^)]*)\)",
                          (src / "stream_select.cu").read_text())
        self.vec = "vec" in proto.group(1)
        types = list(ss._ARGTYPES)
        if not self.vec:
            del types[6]
        self.lib.stream_extract_launch.argtypes = types
        self.lib.stream_extract_launch.restype = ctypes.c_int

    def stream_extract_launch(self, *args):
        if not self.vec:
            args = args[:6] + args[7:]
        return self.lib.stream_extract_launch(*args)


def check_keys(rng):
    """(name, keys, offset) cases for the exactness check."""
    out = [("gauss", rng.standard_normal((6, 24576)), 0)]
    for c in (8, 32, 33):
        x = 5 + rng.random((4, 8192))
        subs = x.reshape(4, 16, 512)
        subs[:, :, np.arange(32)[:min(c, 32)]
             + 32 * (np.arange(32)[:min(c, 32)] % 4)] = 1.0
        if c > 32:
            subs[:, :, 511] = 1.0
        out.append((f"ties_{c}", x, 0))
    x = rng.standard_normal((4, 8192))
    x[rng.random(x.shape) < 0.03] = 0.0
    x[rng.random(x.shape) < 0.03] = -0.0
    out.append(("zeros", x, 0))
    x = np.full((4, 8192), 3.0)
    x[1] = np.inf
    x[1, rng.permutation(8192)[:40]] = 1.0
    x[2, rng.random(8192) < 0.3] = -np.inf
    x[3, 77] = np.nan
    out.append(("constant_starved_neginf_nan", x, 0))
    for length in (8193, 8194, 8195):
        out.append((f"n{length}", rng.standard_normal((3, length)), 0))
    out.append(("offset_view", rng.standard_normal((3, 8192)), 1))
    return [(name, x.astype(np.float32), off) for name, x, off in out]


def exact(dev, cases):
    for name, x, off in cases:
        buf = torch.empty(x.size + off, device=dev)
        keys = buf[off:].view(x.shape)
        keys.copy_(torch.as_tensor(x))
        v, i = ss.stream_extract(keys)
        pv, pi = ss.stream_extract(torch.as_tensor(x))
        v = v.cpu()
        vn, pn = torch.isnan(v), torch.isnan(pv)
        if not (torch.equal(i.cpu(), pi) and torch.equal(vn, pn)
                and torch.equal(v.masked_fill(vn, 0).view(torch.int32),
                                pv.masked_fill(pn, 0).view(torch.int32))):
            return name
    return None


def cold_dev_ms(fn, dev):
    """Device time of ``fn``'s kernel right after a 128 MB write that
    evicts its keys from the 50 MB L2."""
    junk = torch.empty(32 << 20, device=dev)
    return cs.device_ms(lambda: (junk.fill_(1.0), fn()),
                        "stream_extract_kernel")


def main():
    variants = [parse(s, _build.CSRC_DIR) for s in sys.argv[1:]]
    print(f"card: {card_line()}", flush=True)
    libs = build(variants, "stream_select.cu", "stream_extract_kernel",
                 "tune_b5", _build.nvcc_path(), _build.NVCC_FLAGS)
    dev = torch.device("cuda")
    cases = check_keys(np.random.default_rng(0))
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED)
    keys = {s: torch.randn(s, generator=g, device=dev) for s in SHAPES}
    # Sub-chunks with more than 32 keys at the threshold take the eight
    # passes: constant keys, and integers in {0, 1, 2} (~170 ties each).
    slow = {"constant": torch.full(SHAPES[0], 2.5, device=dev),
            "int3": torch.randint(0, 3, SHAPES[0], generator=g,
                                  device=dev).float()}
    srcs = dict(variants)
    for name, path in libs.items():
        entry = _Entry(path, srcs[name])
        ss._lib = lambda: entry
        bad = exact(dev, cases)
        res = {"variant": name, "exact_vs_plain": bad is None}
        if bad is not None:
            res["first_mismatch"] = bad
        for (b, nn), x in keys.items():
            tag = f"{b}x{nn}"
            res[f"{tag}_ms"] = time_ms(lambda: ss._stream_extract_cuda(x), 11)
            res[f"{tag}_dev_ms"] = cs.device_ms(
                lambda: ss._stream_extract_cuda(x), "stream_extract_kernel")
            # A read-only reduction of the same keys: the read rate the
            # card reaches here.
            res[f"{tag}_amin_ms"] = time_ms(lambda: torch.amin(x, 1), 11)
            res[f"{tag}_bound_ms"] = ((4.0 * b * nn + 8.0 * b
                                       * ss.n_candidates(nn))
                                      / cs.PEAK_BYTES * 1e3)
        for tag, x in slow.items():
            res[f"1024x262144_{tag}_dev_ms"] = cs.device_ms(
                lambda: ss._stream_extract_cuda(x), "stream_extract_kernel")
        x = keys[(64, 131072)]
        res["64x131072_cold_dev_ms"] = cold_dev_ms(
            lambda: ss._stream_extract_cuda(x), dev)
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
