"""A benchmark root with the cells' traffic and metrics and tiny
configurations, for the CPU tests: chromosomes of a few hundred bins and
narrow bands, with the callers' other settings as the cells have them."""
import json
import os
import shutil

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
SIZES = {'1': 4_200_000, '2': 3_100_000}


def tiny_config(name, maxapart, maxww=10):
    with open(os.path.join(PKG, 'configs', f'{name}.json')) as f:
        config = json.load(f)
    config['chromsizes'] = dict(SIZES)
    config['settings']['maxapart'] = maxapart
    config['settings']['maxww'] = maxww
    num = maxapart // config['res'] + maxww + 1
    # at a few hundred bins the cells' decay leaves pyHICCUPS no peak to
    # check: the tests draw a flatter band; a quarter of the tiny genome's
    # contacts lie between its chromosomes, as in the cells
    config['synthesis'].update(depth=40.0, decay=0.75,
                               max_loop_span_bins=num - 64,
                               trans_contacts=60_000)
    return config


def with_shelved(spec):
    """``spec`` with the cells of ``portbench/shelved.json`` added, their
    configurations, metrics and metrics' workloads with them."""
    with open(os.path.join(PKG, 'shelved.json')) as f:
        shelved = json.load(f)
    for key in ('configs', 'workloads'):
        spec[key] += shelved[key]
    for key in ('end_to_end', 'per_layer'):
        have = {m['name']: m for m in spec[key]}
        for m in shelved[key]:
            if m['name'] in have:
                have[m['name']]['workloads'] += m['workloads']
            else:
                spec[key].append(m)
    return spec


def make_root(dst):
    """A root at ``dst`` holding a BENCHMARK.json with the repository's
    cells and the shelved ones on tiny configurations, and copies of the
    traffic, mixes, reference and metrics directories; -> dst."""
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        spec = with_shelved(json.load(f))
    os.makedirs(os.path.join(dst, 'portbench', 'configs'))
    for sub in ('traffic', 'mixes', 'reference', 'metrics'):
        shutil.copytree(os.path.join(PKG, sub),
                        os.path.join(dst, 'portbench', sub),
                        ignore=shutil.ignore_patterns('__pycache__'))
    for c in spec['configs']:
        maxapart = 1_500_000 if c['name'].startswith('hiccups') else 1_000_000
        with open(os.path.join(dst, c['file']), 'w') as f:
            json.dump(tiny_config(c['name'], maxapart), f)
    with open(os.path.join(dst, 'BENCHMARK.json'), 'w') as f:
        json.dump(spec, f)
    return str(dst)
