"""Parameter metadata: default prior limits and step sizes, LaTeX labels.

Counterpart of vega_tpu/parameters/param_utils.py (host code, copied).
The data files are the JAX package's own, read by filesystem path.
"""

from __future__ import annotations

from ..utils import JAX_PACKAGE_DIR

DEFAULT_VALUES_FILE = JAX_PACKAGE_DIR / 'parameters' / 'default_values.txt'
LATEX_NAMES_FILE = JAX_PACKAGE_DIR / 'parameters' / 'latex_names.txt'
LATEX_COMPOSITE_FILE = JAX_PACKAGE_DIR / 'parameters' / 'latex_composite.txt'

COMPOSITES = {
    'bias': r'b_{',
    'bias_eta': r'b_{\eta,',
    'beta': r'\beta_{',
    'alpha': r'\alpha_{',
    'par_sigma_smooth': r'\sigma^{full}_{||,',
    'per_sigma_smooth': r'\sigma^{full}_{\bot,',
}


def get_default_values():
    """Default prior limits and minimizer step sizes
    (reference: param_utils.py:100-123)."""
    defaults = {}
    with open(DEFAULT_VALUES_FILE) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            name, rest = line.split('=', 1)
            lo, hi, err = rest.split()
            defaults[name.strip()] = {
                'limits': (float(lo), float(hi)),
                'error': float(err),
            }
    return defaults


def get_latex(path):
    """Two-column name -> LaTeX mapping (reference: param_utils.py:66-99)."""
    latex_names = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == '#':
                continue
            items = line.split()
            latex_names[items[0]] = ' '.join(items[1:])
    return latex_names


def build_names(params):
    """LaTeX labels for parameter names, composing tracer subscripts when
    no full name exists (reference: param_utils.py:13-64)."""
    latex_full = get_latex(LATEX_NAMES_FILE)
    latex_comp = get_latex(LATEX_COMPOSITE_FILE)

    latex_names = {}
    for name in params:
        if name in latex_full:
            latex_names[name] = latex_full[name]
            continue

        tracer = None
        for subset in latex_comp:
            if subset.lower() in name.lower():
                tracer = subset
        comp_par = None
        for comp in COMPOSITES:
            if comp in name:
                comp_par = comp

        if tracer is not None and comp_par is not None:
            comp_name = comp_par + '_' + tracer
            latex_names[comp_name] = (COMPOSITES[comp_par]
                                      + latex_comp[tracer] + r'}')
        elif comp_par is not None:
            latex_names[name] = (COMPOSITES[comp_par]
                                 + name[len(comp_par) + 1:] + r'}')
        else:
            latex_names[name] = name

    return latex_names
