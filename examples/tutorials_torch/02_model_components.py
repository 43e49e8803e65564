"""Tutorial 2 — Inside the model: components, Pk/Xi saving, direct Pk,
with the PyTorch port (vega_tpu_torch) on the GPU.

Counterpart of examples/tutorials/02_model_components.py: evaluate the
model with component saving on (peak/smooth decomposition, per-stage Pk
and xi), and run a direct full-Pk model.

Run:  python 02_model_components.py [--device cpu] [--size tiny]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse   # noqa: E402
import tempfile   # noqa: E402

import numpy as np   # noqa: E402

from vega_tpu_torch.testing import make_synthetic_dataset   # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface     # noqa: E402


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--device', default='cuda',
                      help="'cuda', 'cuda:N' or 'cpu'")
    pars.add_argument('--size', default='full', choices=('full', 'tiny'),
                      help='size of the synthetic dataset')
    args = pars.parse_args(argv)

    workdir = tempfile.mkdtemp(prefix='vega_tutorial_')
    main_path = make_synthetic_dataset(workdir, cross=False, size=args.size,
                                       device=args.device)
    vega = VegaInterface(main_path, device=args.device)

    # --- Component saving: set save-components before building models --
    vega.fiducial['save-components'] = True
    vega.compute_model(run_init=True)          # rebuild with saving enabled

    model = vega.models['lyaxlya']
    print('saved Pk stages:', sorted(model.pk['peak'].keys()))
    print('saved xi stages:', sorted(model.xi['smooth'].keys()))
    pk_peak = np.asarray(model.pk['peak']['core'])
    print(f'peak-component P(k, mu_k) grid: {pk_peak.shape}, '
          f'mean {pk_peak.mean():.4f}')
    xi_dist = np.asarray(model.xi_distorted['smooth']['core'])
    print(f'distorted smooth xi: {xi_dist.shape}, mean {xi_dist.mean():.3e}')

    # The full model is bao_amp * peak + smooth at the xi level
    full = vega.compute_model(run_init=False)['lyaxlya']
    recon = (vega.params['bao_amp']
             * np.asarray(model.xi_distorted['peak']['core']) + xi_dist)
    same = bool(np.allclose(recon, full))
    print('peak+smooth == full:', same)

    # --- Direct Pk: hand the model an arbitrary linear P(k) ------------
    pk_custom = np.asarray(vega.fiducial['pk_full']) * 1.05
    direct = vega.compute_model(run_init=False, direct_pk=pk_custom)
    print(f'direct-Pk model mean: {direct["lyaxlya"].mean():.3e}')
    return {'pk_stages': sorted(model.pk['peak'].keys()),
            'xi_stages': sorted(model.xi['smooth'].keys()),
            'pk_peak_mean': float(pk_peak.mean()),
            'xi_dist_mean': float(xi_dist.mean()),
            'peak_plus_smooth_is_full': same,
            'direct_mean': float(direct['lyaxlya'].mean())}


if __name__ == '__main__':
    main()
