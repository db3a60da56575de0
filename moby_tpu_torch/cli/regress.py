"""`moby-regress` equivalent: run a scene, dump per-step Euler coordinates
(counterpart of ``moby_tpu/cli/regress.py``).

Output format mirrors programs/regress.cpp: one line per step
`t q0 q1 ...` with bodies sorted alphabetically by id (disabled bodies have
no generalized coordinates and are omitted), first line at t=0, last line is
the wall-clock seconds of the run. Numbers are printed with `%g` (6
significant digits), so two dumps of equal states may differ by one unit in
the sixth digit.

The scene runs on the card in float32 unless `--cpu` asks for the CPU, where
it runs in float64 (the regression mode).

Usage: python -m moby_tpu_torch.cli.regress [-s=H] [-mt=T] [-mi=N] [--cpu] scene.xml out.dat
"""

from __future__ import annotations

import sys
import time


def _entries(scene):
    """(kind, ref, name) of every body with generalized coordinates, sorted
    by id: enabled free bodies, then articulated bodies (programs/regress.cpp:
    80-92)."""
    entries = [("free", i, scene.body_names[i]) for i in range(scene.nb)
               if bool(scene.host["enabled"][i])]
    entries += [("art", ent, ent.name) for ent in scene.arts]
    return sorted(entries, key=lambda e: e[2])


def _art_coords(ent, q_art):
    """Euler coordinates of one articulated body: joint coordinates, then the
    floating base's pose."""
    from ..dynamics import model as amdl

    m = ent.model
    q = q_art[ent.q_off: ent.q_off + m.nq]
    vals, base = [], None
    for i in range(m.nl):
        t = m.jtype[i]
        o = m.q_off[i]
        if t == amdl.FLOATING:
            base = q[o: o + 7]
        elif amdl.NQ[t]:
            vals.extend(q[o: o + amdl.NQ[t]].tolist())
    if base is not None:
        vals.extend(base.tolist())
    return vals


def dump(scene, st, dt, f, max_time=float("inf"), max_iter=float("inf"),
         device="cuda"):
    """Step scenario 0 of `st` and write one `t q...` line per step to the
    open file `f` (the initial state first). Returns the final state."""
    from ..sim import stepper

    entries = _entries(scene)

    def writeline(s):
        pos, qt = s.pos[0].cpu().numpy(), s.quat[0].cpu().numpy()
        q_art = s.q_art[0].cpu().numpy()
        vals = [float(s.time[0])]
        for kind, ref, _name in entries:
            if kind == "free":
                vals.extend(pos[ref].tolist())
                vals.extend(qt[ref].tolist())
            else:
                vals.extend(_art_coords(ref, q_art))
        f.write(" ".join(f"{v:g}" for v in vals) + "\n")

    it = 0
    writeline(st)
    while it < max_iter and float(st.time[0]) <= max_time:
        st = stepper.step(scene, st, dt, device=device)
        it += 1
        if float(st.time[0]) > max_time or it >= max_iter:
            break
        writeline(st)
    return st


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    step_size = None
    max_time = float("inf")
    max_iter = float("inf")
    device = "cuda"
    pos_args = []
    for a in argv:
        if a.startswith("-s="):
            step_size = float(a[3:])
        elif a.startswith("-mt="):
            max_time = float(a[4:])
        elif a.startswith("-mi="):
            max_iter = int(a[4:])
        elif a.startswith("-p="):
            raise NotImplementedError(
                f"plugin scenes (-p={a[3:]}) are not ported yet")
        elif a == "--cpu":
            device = "cpu"
        elif a.startswith("-"):
            pass  # ignore unsupported flags (logging, ...)
        else:
            pos_args.append(a)
    if len(pos_args) < 1:
        print(__doc__)
        return 1
    xml_path = pos_args[0]
    out_path = pos_args[1] if len(pos_args) > 1 else "regress.out"

    from ..io import mobyxml

    scene, st, opts = mobyxml.load(xml_path, device=device)
    dt = step_size if step_size is not None else opts.step_size

    t_start = time.time()
    with open(out_path, "w") as f:
        dump(scene, st, dt, f, max_time, max_iter, device=device)
        f.write(f"{time.time() - t_start:g}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
