"""Seeded float weights of a configuration, made on the device in a few
large calls from its reference's ``param_spec``.  The program loads them
into its modules by name; the reference reads the same tensors.

Kinds (``chip_smoke.py:442`` ``seed_weights``'s distributions): ``conv``
He-normal over the fan-in; ``bn_weight`` 1 + 0.1 N(0, 1); ``bias``
0.1 N(0, 1) (biases and BatchNorm shifts and running means); ``bn_var``
0.5 + U(0, 1); ``count`` a zero int64 counter.  Each tensor is then scaled
by its ``factor``."""

import math

import torch


def make(spec: list, device, seed: int) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [s for s in spec if s[2] in ("conv", "bn_weight", "bias")]
    uniform = [s for s in spec if s[2] == "bn_var"]
    z = torch.randn(sum(math.prod(s[1]) for s in normal), generator=gen, device=device)
    u = torch.rand(sum(math.prod(s[1]) for s in uniform), generator=gen, device=device)
    out, iz, iu = {}, 0, 0
    for name, shape, kind, factor in spec:
        n = math.prod(shape)
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if kind == "bn_var":
            t = 0.5 + u[iu:iu + n]
            iu += n
        else:
            t = z[iz:iz + n]
            iz += n
            if kind == "conv":
                t = t * math.sqrt(2.0 / math.prod(shape[1:]))
            elif kind == "bn_weight":
                t = 1.0 + 0.1 * t
            else:
                t = 0.1 * t
        out[name] = (t * factor).reshape(shape).contiguous()
    return out
