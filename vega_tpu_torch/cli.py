"""Console entry point: one command for the port's three scripts.

    python -m vega_tpu_torch.cli fit main.ini [--device cpu]
    python -m vega_tpu_torch.cli sample main.ini [--device cpu]
    python -m vega_tpu_torch.cli mc main.ini [--sequential] [--device cpu]

Counterpart of vega_tpu/cli.py: `fit` runs scripts/run_vega.py, `sample`
scripts/run_vega_sampler.py and `mc` scripts/run_vega_mc.py, each on the
card unless --device says otherwise.
"""

import argparse
import sys

DEVICE_HELP = "Device to run on: 'cuda', 'cuda:N' or 'cpu'"


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='vega_tpu_torch — the PyTorch / CUDA Lyman-alpha forest '
                    'correlation-function likelihood engine')
    sub = parser.add_subparsers(dest='command')

    fit = sub.add_parser('fit', help='Run a fit (minimize + output + plots)')
    fit.add_argument('config', type=str)
    fit.add_argument('--device', type=str, default='cuda', help=DEVICE_HELP)

    sampler = sub.add_parser('sample', help='Run the sampler')
    sampler.add_argument('config', type=str)
    sampler.add_argument('--device', type=str, default='cuda',
                         help=DEVICE_HELP)

    mc = sub.add_parser('mc', help='Run Monte-Carlo mock fits')
    mc.add_argument('config', type=str)
    mc.add_argument('--sequential', action='store_true')
    mc.add_argument('--n-devices', type=int, default=None)
    mc.add_argument('--device', type=str, default='cuda', help=DEVICE_HELP)

    args = parser.parse_args(argv)

    if args.command == 'fit':
        from vega_tpu_torch.scripts.run_vega import run_vega
        run_vega(args.config, args.device)
        return 0
    if args.command == 'sample':
        from vega_tpu_torch.scripts.run_vega_sampler import main as sample
        return sample([args.config, '--device', args.device])
    if args.command == 'mc':
        from vega_tpu_torch.scripts.run_vega_mc import main as run_mc
        argv2 = [args.config, '--device', args.device]
        if args.sequential:
            argv2 += ['--sequential']
        if args.n_devices:
            argv2 += ['--n-devices', str(args.n_devices)]
        return run_mc(argv2)

    parser.print_help()
    return 0


if __name__ == '__main__':
    sys.exit(main())
