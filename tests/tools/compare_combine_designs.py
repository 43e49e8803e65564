#!/usr/bin/env python3
"""Time another checkout's spline + Legendre kernels against this
checkout's, in turns, on one card.

    git archive <commit> | tar -x -C build/earlier
    python3 chip_smoke.py | tee smoke.log
    python3 tests/tools/compare_combine_designs.py --earlier build/earlier \
        --smoke-log smoke.log [--out designs.json]

The earlier checkout sits in a directory .gitignore lists. Each tree is
driven through its public wrappers (vega_tpu_torch.ops.spline_combine:
combine_forward, combine_points, combine_transpose) in a process of its
own, which imports that tree's package and builds that tree's kernels, so
no C interface is assumed. The layouts are those of chip_smoke.py's
kernels record (every layout a path launched, its launches in the path's
run, its bound and its knot range). Turns: earlier, this, this, earlier.
Each turn takes every layout on the same random inputs
(chip_smoke.random_case, seed 0) and gives max|diff| against the plain
version, whether two launches agree bit for bit, `ms` the device time
per launch (chip_smoke.device_ms: launches queued behind a spin kernel)
and `call_ms` one wrapper call with the host's issue time
(chip_smoke.cuda_time_ms, median of chip_smoke.CALL_REPEATS means). A
call is "slower" or "faster" only where both turns of one design lie on
one side of both turns of the other. Prints one line per layout, then
per path an
estimate of the combine's device time in the path's run: launches x ms,
summed over the path's layouts, each layout timed alone. Needs one card,
no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
ITERS = 20


def chip_smoke():
    """This checkout's chip_smoke.py as a module; it imports
    vega_tpu_torch only inside its functions, from sys.path."""
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def layouts_of(smoke_log):
    """Every checked f64 layout of the kernels record in a chip_smoke.py
    log (the f32 kernels have no earlier design to time against), each
    once (a layout held in an earlier path carries `held_in`)."""
    for line in Path(smoke_log).read_text().splitlines():
        if line.startswith('{"kernels"'):
            return [r for k in json.loads(line)['kernels']
                    for r in k['layouts'] if r.get('dtype', 'f64') == 'f64'
                    and 'held_in' not in r]
    raise SystemExit(f'no kernels record in {smoke_log}')


def turn(tree, layouts):
    """Every layout through `tree`'s wrappers: one row each."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import vega_tpu_torch
    from vega_tpu_torch.ops.spline_combine import KnotGrid
    if not Path(vega_tpu_torch.__file__).resolve().is_relative_to(
            Path(tree).resolve()):
        raise SystemExit(f'imported {vega_tpu_torch.__file__}, not {tree}')
    cs = chip_smoke()
    cs.build_kernels()
    device = torch.device('cuda', torch.cuda.current_device())
    rng = np.random.default_rng(0)
    rows = []
    for rec in layouts:
        layout = tuple(rec['layout'])
        grid = KnotGrid.build(np.linspace(*rec['knots'], layout[2]), device)
        inputs = cs.random_case(rng, device, grid, layout)
        run = cs.kernel_call(rec['primitive'], rec['order'], grid, layout[3],
                             *inputs)
        out, again, ref = run(True), run(True), run(False)
        rows.append({
            'max_abs_err': max(float((o - r).abs().max())
                               for o, r in zip(out, ref)),
            'max_abs_ref': max(float(r.abs().max()) for r in ref),
            'repeatable': all(torch.equal(a, b) for a, b in zip(out, again)),
            'ms': cs.device_ms(lambda: run(True), ITERS),
            'call_ms': cs.cuda_time_ms(lambda: run(True), ITERS,
                                       cs.CALL_REPEATS)})
    return rows


def versus(this, earlier):
    """'slower' / 'faster' where both turns of this design lie on one side
    of both of the earlier's, else 'within the turns' spread'."""
    if min(this) > max(earlier):
        return 'slower'
    if max(this) < min(earlier):
        return 'faster'
    return "within the turns' spread"


def describe(cs, rec, row, ms):
    """One layout's line: both designs' device and call ms per turn, the
    bound, the errors and whether two launches agreed."""
    earlier, this = row['earlier'], row['this']
    label = cs.layout_label(rec['primitive'], rec['order'], row['layout'])
    return (
        f'{rec["path"]} {label}: device ms earlier {earlier["ms"][0]:.4f} / '
        f'{earlier["ms"][1]:.4f}, this {this["ms"][0]:.4f} / '
        f'{this["ms"][1]:.4f} (x{ms["earlier"] / ms["this"]:.2f}, '
        f'{versus(this["ms"], earlier["ms"])}); a call earlier '
        f'{earlier["call_ms"][0]:.4f} / {earlier["call_ms"][1]:.4f}, this '
        f'{this["call_ms"][0]:.4f} / {this["call_ms"][1]:.4f} ms '
        f'({versus(this["call_ms"], earlier["call_ms"])}); bound '
        f'{rec["bound_ms"]:.5f} ms (this {rec["bound_ms"] / ms["this"]:.1%}); '
        f'{rec["launches"]} launches; '
        f'max|diff| earlier {max(earlier["max_abs_err"]):.2e}, this '
        f'{max(this["max_abs_err"]):.2e} (max|ref| '
        f'{row["max_abs_ref"]:.2e}); two launches equal: earlier '
        f'{all(earlier["repeatable"])}, this {all(this["repeatable"])}')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--earlier', type=Path,
                        help='the other checkout (a directory)')
    parser.add_argument('--smoke-log', type=Path,
                        help="a log of this checkout's chip_smoke.py")
    parser.add_argument('--out', type=Path, default=None)
    parser.add_argument('--turn', type=Path, help=argparse.SUPPRESS)
    parser.add_argument('--layouts', type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.turn is not None:        # one turn, in a process of its own
        layouts = json.loads(args.layouts.read_text())
        print(json.dumps(turn(args.turn, layouts)))
        return
    if args.earlier is None or args.smoke_log is None:
        parser.error('--earlier and --smoke-log are required')

    cs = chip_smoke()
    layouts = layouts_of(args.smoke_log)
    trees = {'earlier': args.earlier, 'this': ROOT}
    order = ('earlier', 'this', 'this', 'earlier')
    turns = []
    with tempfile.TemporaryDirectory() as work:
        path = Path(work) / 'layouts.json'
        path.write_text(json.dumps(layouts))
        for name in order:
            proc = subprocess.run(
                [sys.executable, __file__, '--turn', str(trees[name]),
                 '--layouts', str(path)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f'{name} turn failed:\n{proc.stdout[-4000:]}'
                                 f'\n{proc.stderr[-4000:]}')
            turns.append(json.loads(proc.stdout.splitlines()[-1]))

    rows, by_path = [], {}
    for i, rec in enumerate(layouts):
        got = {name: [t[i] for n, t in zip(order, turns) if n == name]
               for name in trees}
        row = {key: rec[key] for key in ('path', 'primitive', 'order',
                                         'layout', 'launches', 'bound_ms')}
        for name, pair in got.items():
            row[name] = {key: [r[key] for r in pair]
                         for key in ('ms', 'call_ms', 'max_abs_err',
                                     'repeatable')}
        row['max_abs_ref'] = got['this'][0]['max_abs_ref']
        rows.append(row)
        ms = {name: float(np.mean(row[name]['ms'])) for name in trees}
        for name in trees:
            total = by_path.setdefault(rec['path'], {}).setdefault(name, 0.0)
            by_path[rec['path']][name] = total + rec['launches'] * ms[name]
        print(describe(cs, rec, row, ms), flush=True)
    for path, total in by_path.items():
        print(f'{path}: estimated combine device time in the run (launches '
              f'x ms of each layout timed alone): earlier '
              f'{total["earlier"]:.3f} ms, this {total["this"]:.3f} ms',
              flush=True)
    card = cs.card_line()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({'card': card, 'layouts': rows,
                                        'estimate_ms_by_path': by_path}))
    print(json.dumps({'card': card, 'estimate_ms_by_path': by_path}))


if __name__ == '__main__':
    main()
