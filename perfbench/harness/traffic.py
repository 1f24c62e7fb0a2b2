"""The one generator of every traffic mix: a closed loop of solves (one
client, one solve at a time), its inputs made from the run's seed.

Every mix solves the upstream's variable-theta_n MMS problem (its
`solve.py`): theta_n = 0.5 + 0.25 sin 2 pi x sin 2 pi y, and b = the
problem's forcing (the continuous operator's image of un = sin 2 pi x
cos 2 pi y, vn = cos 2 pi x sin 2 pi y, us = -un, vs = -vn, p = 0) plus
A w for a smooth manufactured load w, so that the solve's answer is the
forcing's plus w. A is the plain reference's operator of the step's
theta_n (`perfbench/reference/`): b is in A's range, and the program sees
only b (and, where it rebuilds, theta_n's planes).

A mix is a data file, `perfbench/traffic/<name>.json`:

  kind    "fixed": every step solves on the same theta_n, whose operator,
          preconditioner and graph set-up builds once; load j's w is
          translated by its own offset, drawn uniformly from [0, 1)^2.
          "moving": load j moves theta_n by a whole number of cells in x
          and in y, each drawn uniformly from [0, n) (uniform advection on
          the periodic square), and moves the forcing and load 0's w with
          it, so that every step solves a translate of one problem on an
          operator, preconditioner and graph built anew from its planes;
  loads   M: the mix holds M loads, the same for every seed, and each run
          steps through them in cycles of M, each cycle in an order drawn
          from (seed, cycle), so that every run does the same set of work
          in another order (step 0, the warm-up, takes load 0);
  fields  w's five fields (un, vn, us, vs, p), each a list of modes [kx,
          ky, amplitude, phase]: amplitude * cos(2 pi (kx x + ky y +
          phase)) (phase in turns).

Every field is evaluated at its own MAC points (cell centres ((c+1/2)h,
-(r+1/2)h), u-faces (c h, -(r+1/2)h), v-faces ((c+1/2)h, -r h), h = 1/n),
in float64 on the device, from a handful of host numbers per step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from perfbench.reference import multiphase as reference

KINDS = ("fixed", "moving")
# the streams of random numbers: a load's offset and shift are drawn from
# (LOAD_SET, load, stream), the same for every run; a cycle's order and a
# step's sampling from (seed, cycle or step, stream)
_OFFSET, _SHIFT, _SAMPLE, _ORDER = 1, 2, 3, 4
LOAD_SET = 0


def rng(seed: int, index: int, stream: int) -> np.random.Generator:
    """The generator of one stream; any seed >= 0 (also past 32 bits)."""
    return np.random.default_rng([int(seed), int(index), stream])


def _coords(n: int, device, x0: float, y0: float):
    idx = torch.arange(n, dtype=torch.float64, device=device)
    return (idx + x0) / n, -(idx + y0) / n        # x along c, y along r


# (x offset, y offset) of the points of un, vn, us, vs and p, in cells
_POINTS = {"u": (0.0, 0.5), "v": (0.5, 0.0), "cell": (0.5, 0.5)}
FIELDS = ("un", "vn", "us", "vs", "p")
_FIELD_POINTS = ("u", "v", "u", "v", "cell")


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A mix's parameters (the data file) bound to a grid, a device and a
    seed."""

    spec: dict
    n: int
    device: torch.device
    seed: int

    def __post_init__(self):
        if self.spec["kind"] not in KINDS:
            raise ValueError(f"unknown mix kind {self.spec['kind']!r}")

    @property
    def moving(self) -> bool:
        """Whether every step builds its own operator (module docstring)."""
        return self.spec["kind"] == "moving"

    def load(self, step: int) -> int:
        """The load step `step` solves (module docstring)."""
        if step == 0:
            return 0
        m = int(self.spec["loads"])
        cycle, pos = divmod(step - 1, m)
        return int(rng(self.seed, cycle, _ORDER).permutation(m)[pos])

    def shift(self, step: int) -> tuple[int, int]:
        """(rows, columns) by which step `step` moves theta_n."""
        if not self.moving:
            return (0, 0)
        sy, sx = rng(LOAD_SET, self.load(step), _SHIFT).integers(
            0, self.n, size=2)
        return int(sy), int(sx)

    def theta(self, step: int) -> dict:
        """theta_n's planes of step `step`: {"cell", "xface_pt",
        "yface_pt"}, (n, n) float64 each."""
        out = {}
        for key, pt in (("cell", "cell"), ("xface_pt", "u"),
                        ("yface_pt", "v")):
            x, y = _coords(self.n, self.device, *_POINTS[pt])
            out[key] = 0.5 + 0.25 * torch.outer(torch.sin(2 * math.pi * y),
                                                torch.sin(2 * math.pi * x))
        return _moved(out, self.shift(step))

    def solution(self, step: int) -> torch.Tensor:
        """w of step `step`, (5, n, n) float64."""
        if self.moving:
            return _moved({"w": self._field(0)}, self.shift(step))["w"]
        return self._field(self.load(step))

    def rhs(self, step: int, params: dict) -> torch.Tensor:
        """b = forcing + A w of step `step`, flat (5 n^2,) float64;
        `params` are the operator's scalars."""
        b = reference.apply(self.theta(step), params, self.solution(step))
        b += _moved({"f": self._mms_forcing(params)}, self.shift(step))["f"]
        return b.reshape(-1)

    def _mms_forcing(self, params: dict) -> torch.Tensor:
        """The variable-theta MMS problem's right-hand side at the MAC
        points (nu = 1)."""
        c, d, xi = params["c"], params["d"], params["xi"]
        pi2 = math.pi ** 2
        out = torch.empty((5, self.n, self.n), dtype=torch.float64,
                          device=self.device)

        def grid(pt):
            x, y = _coords(self.n, self.device, *_POINTS[pt])
            return y[:, None], x[None, :]

        for k, (eta, sign) in enumerate(((params["eta_n"], 1.0),
                                         (params["eta_s"], -1.0))):
            for f, pt in ((2 * k, "u"), (2 * k + 1, "v")):
                y, x = grid(pt)
                sx, sy = torch.sin(2 * math.pi * x), torch.sin(2 * math.pi * y)
                bracket = (sign * (4 * c - 4 * d * (8 * eta * pi2 + xi))
                           + 2 * (c - 16 * d * eta * pi2) * sx * sy
                           + sign * d * xi * sx * sx * sy * sy)
                lead = (torch.cos(2 * math.pi * y) * sx if pt == "u"
                        else torch.cos(2 * math.pi * x) * sy)
                out[f] = lead * bracket / 8
        y, x = grid("cell")
        out[4] = -math.pi * torch.sin(4 * math.pi * x) * torch.sin(
            4 * math.pi * y)
        return out

    def _field(self, load: int) -> torch.Tensor:
        offset = rng(LOAD_SET, load, _OFFSET).uniform(0.0, 1.0, size=2)
        w = torch.zeros((5, self.n, self.n), dtype=torch.float64,
                        device=self.device)
        for f, (name, pt) in enumerate(zip(FIELDS, _FIELD_POINTS)):
            modes = np.asarray(self.spec["fields"][name], dtype=np.float64)
            if not len(modes):
                continue
            kx, ky, amp, phase = modes.T
            turns = kx * offset[0] + ky * offset[1] + phase
            x, y = _coords(self.n, self.device, *_POINTS[pt])

            def dev(a):
                return torch.as_tensor(a, device=self.device)

            ay = 2 * math.pi * (torch.outer(y, dev(ky)) + dev(turns))
            ax = 2 * math.pi * torch.outer(x, dev(kx))       # (n, modes)
            # sum_m a_m cos(ay + ax) as two products of (n, m) by (m, n)
            w[f] = (torch.cos(ay) * dev(amp)) @ torch.cos(ax).T \
                - (torch.sin(ay) * dev(amp)) @ torch.sin(ax).T
        return w

    def sampled(self, step: int, share: float) -> bool:
        """Whether the answer of window step `step` (numbered from 1; step
        0 is the warm-up) is among those checked: the first always, any
        other with probability `share`, by the seed."""
        return step == 1 or rng(self.seed, step, _SAMPLE).random() < share


def _moved(planes: dict, shift: tuple[int, int]) -> dict:
    """Each plane moved by (rows, columns): y[r, c] = a[r - sy, c - sx]."""
    if shift == (0, 0):
        return planes
    return {k: torch.roll(a, shifts=shift, dims=(-2, -1))
            for k, a in planes.items()}
