"""Carry weights across from and to the JAX package: flax checkpoints <->
the port's state dict, with no msgpack package and no JAX.

A flax checkpoint (``flax.serialization.to_bytes``) is a msgpack map of
maps whose leaves are msgpack ext type 1: a nested msgpack array
``(shape, dtype name, raw bytes)``. :func:`load_flax_msgpack` reads that
with a small stdlib-only decoder; :func:`params_from_flax` maps the numpy
tree (the same tree JAX's ``variables`` hold) onto the port's modules.
:func:`flax_from_params` and :func:`flax_msgpack_bytes` go the other way,
byte for byte as flax writes the same tree. :func:`flax_param_tree` and
:func:`param_tensors_from_flax` apply the parameters' map to per-parameter
tensors such as AdamW's moments (optax's ``mu`` and ``nu`` trees); one
table, :func:`_leaves`, holds the map.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct

import numpy as np
import torch

from tpu_pillars_torch.config import PillarsConfig

_EXT_NDARRAY = 1


class _Reader:
    """Minimal msgpack decoder for flax checkpoints: ints, str, bin, arrays,
    maps and ext (ext type 1 decodes to a numpy array). Any other type byte
    is refused."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode("utf-8")
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}          # bin 8/16/32
        if b in sized:
            return bytes(self._take(self._unpack(sized[b])))
        ext = {0xC7: "B", 0xC8: "H", 0xC9: "I"}            # ext 8/16/32
        if b in ext:
            n = self._unpack(ext[b])
            return self._ext(self._unpack("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self._unpack("b"), fixext[b])
        scalars = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self._unpack(scalars[b])
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strs:
            return self._take(self._unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack("H" if b == 0xDC else "I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(payload).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def load_flax_msgpack(path: str) -> dict:
    """Read a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def config_fingerprint(config: PillarsConfig) -> np.ndarray:
    """Stable 8-byte digest of a PillarsConfig, as checkpoints store it."""
    text = repr(sorted(dataclasses.asdict(config).items())).encode()
    return np.frombuffer(hashlib.sha256(text).digest()[:8], np.uint8).copy()


def check_fingerprint(tree: dict, config: PillarsConfig, path: str) -> None:
    """Refuse a checkpoint written for another config (when it recorded
    one)."""
    if "config_fp" not in tree:
        return
    want = config_fingerprint(config)
    got = np.asarray(tree["config_fp"], np.uint8)
    if not np.array_equal(want, got):
        raise ValueError(
            f"checkpoint {path} was written for a different PillarsConfig "
            f"(fingerprint {got.tobytes().hex()} != {want.tobytes().hex()}); "
            f"refusing to restore")


def _leaves(config: PillarsConfig):
    """The one map between the port's state dict and the flax variables:
    (flax collection, flax path, port name, to_flax, from_flax) for every
    leaf, the two functions acting on numpy arrays.

    Layouts: flax Conv kernels (kh, kw, in, out) are torch (out, in, kh,
    kw); flax ConvTranspose kernels are applied spatially flipped relative
    to torch's ConvTranspose2d (in, out, kh, kw), so they are flipped as
    well as permuted; the head kernels keep flax's (C, out) columns of its
    (1, 1, C, out) conv kernel; the PFN kernel keeps flax's (in, out)."""
    same = (lambda a: a, lambda a: a)
    c = 3 * config.rpn_up_channels
    out = [("params", ("pfn", "linear", "kernel"), "pfn.kernel", *same)]

    def bn(path, prefix):
        out.extend([("params", path + ("scale",), f"{prefix}.weight", *same),
                    ("params", path + ("bias",), f"{prefix}.bias", *same),
                    ("batch_stats", path + ("mean",),
                     f"{prefix}.running_mean", *same),
                    ("batch_stats", path + ("var",),
                     f"{prefix}.running_var", *same)])

    bn(("pfn", "bn"), "pfn.bn")
    for i, n_layers in enumerate(config.rpn_layers):
        for j in range(n_layers):
            out.append(("params", ("rpn", f"block{i}", f"conv{j}", "kernel"),
                        f"rpn.blocks.{i}.convs.{j}",
                        lambda a: a.transpose(2, 3, 1, 0),
                        lambda a: a.transpose(3, 2, 0, 1)))
            bn(("rpn", f"block{i}", f"bn{j}"), f"rpn.blocks.{i}.bns.{j}")
        out.append(("params", ("rpn", f"up{i}", "deconv", "kernel"),
                    f"rpn.ups.{i}.weight",
                    lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
                    lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1)))
        bn(("rpn", f"up{i}", "bn"), f"rpn.ups.{i}.bn")
    for name in ("cls", "box", "dir"):
        out.append(("params", ("head", name, "kernel"), f"head.{name}.weight",
                    lambda a: a.reshape(1, 1, c, -1),
                    lambda a: a.reshape(c, -1)))
        out.append(("params", ("head", name, "bias"), f"head.{name}.bias",
                    *same))
    return out


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _sorted_tree(leaves) -> dict:
    """{path: array} -> nested dict, keys sorted at every level (the order
    a jitted JAX state carries)."""
    tree: dict = {}
    for path, value in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def sort(node):
        if isinstance(node, dict):
            return {k: sort(node[k]) for k in sorted(node)}
        return node

    return sort(tree)


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _from_flax(variables: dict, config: PillarsConfig, cols) -> dict:
    return {name: _to_torch(from_flax(np.asarray(_get(variables[col], path))))
            for col, path, name, _, from_flax in _leaves(config)
            if col in cols}


def _to_flax(named: dict, config: PillarsConfig, col: str) -> dict:
    return _sorted_tree({
        path: np.ascontiguousarray(to_flax(_to_numpy(named[name])))
        for c, path, name, to_flax, _ in _leaves(config) if c == col})


def params_from_flax(variables: dict, config: PillarsConfig) -> dict:
    """Flax variables {'params', 'batch_stats'} as numpy -> state dict of
    ``models.pointpillars.PointPillars`` (layouts: :func:`_leaves`;
    BatchNorm keeps its running statistics, eps 1e-3 is the modules')."""
    return _from_flax(variables, config, ("params", "batch_stats"))


def flax_from_params(state_dict: dict, config: PillarsConfig) -> dict:
    """Inverse of :func:`params_from_flax`: the port's state dict -> flax
    variables {'params', 'batch_stats'} as numpy, keys sorted at every
    level."""
    return {col: _to_flax(state_dict, config, col)
            for col in ("params", "batch_stats")}


def flax_param_tree(named: dict, config: PillarsConfig) -> dict:
    """Per-parameter tensors by the port's parameter names (AdamW's
    moments, an EMA) -> a tree shaped as the flax ``params``, by the map
    :func:`flax_from_params` applies to the parameters themselves: the
    layout of optax's ``mu`` and ``nu``."""
    return _to_flax(named, config, "params")


def param_tensors_from_flax(tree: dict, config: PillarsConfig) -> dict:
    """Inverse of :func:`flax_param_tree`: a ``params``-shaped tree ->
    {port parameter name: tensor}."""
    return _from_flax({"params": tree}, config, ("params",))


def _pack(obj, out: list) -> None:
    """msgpack encoding of dict / list / tuple / str / bytes / int /
    ndarray (ext type 1, as flax writes arrays), smallest forms first, as
    the msgpack package packs them."""
    if isinstance(obj, dict):
        n = len(obj)
        out.append(bytes([0x80 | n]) if n < 16 else
                   struct.pack(">BH", 0xDE, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xDF, n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(bytes([0x90 | n]) if n < 16 else
                   struct.pack(">BH", 0xDC, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xDD, n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        out.append(bytes([0xA0 | n]) if n < 32 else
                   struct.pack(">BB", 0xD9, n) if n < 1 << 8 else
                   struct.pack(">BH", 0xDA, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xDB, n))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        out.append(struct.pack(">BB", 0xC4, n) if n < 1 << 8 else
                   struct.pack(">BH", 0xC5, n) if n < 1 << 16 else
                   struct.pack(">BI", 0xC6, n))
        out.append(bytes(obj))
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        v = int(obj)
        if 0 <= v < 0x80:
            out.append(bytes([v]))
        elif -32 <= v < 0:
            out.append(struct.pack(">b", v))
        elif v >= 0:
            for code, fmt, lim in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                   (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
                if v < lim:
                    out.append(struct.pack(">B" + fmt, code, v))
                    break
        else:
            for code, fmt, lim in ((0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15),
                                   (0xD2, "i", 1 << 31), (0xD3, "q", 1 << 63)):
                if v >= -lim:
                    out.append(struct.pack(">B" + fmt, code, v))
                    break
    elif isinstance(obj, np.ndarray):
        inner: list = []
        _pack((tuple(obj.shape), obj.dtype.name, obj.tobytes("C")), inner)
        data = b"".join(inner)
        n = len(data)
        fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fix:
            out.append(struct.pack(">Bb", fix[n], _EXT_NDARRAY))
        elif n < 1 << 8:
            out.append(struct.pack(">BBb", 0xC7, n, _EXT_NDARRAY))
        elif n < 1 << 16:
            out.append(struct.pack(">BHb", 0xC8, n, _EXT_NDARRAY))
        else:
            out.append(struct.pack(">BIb", 0xC9, n, _EXT_NDARRAY))
        out.append(data)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def flax_msgpack_bytes(tree: dict) -> bytes:
    """Encode a nested dict of numpy arrays the way
    ``flax.serialization.to_bytes`` lays it out; :func:`load_flax_msgpack`
    and flax's ``msgpack_restore`` read it back."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
