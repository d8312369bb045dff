"""The port's plotting CLIs (hicpeaks_tpu_torch/cli/apa.py with
``--device cpu``, cli/peakplot.py) against the JAX CLIs' default runs, in
process, on one synthetic cooler and loop list: byte-identical PNG files
(one matplotlib in one process, so even the metadata agrees), and
``CoolerLite.fetch_dense_region`` equal to the JAX reader's."""
import numpy as np
import pytest

from hicpeaks_tpu.cli import apa as japa
from hicpeaks_tpu.cli import peakplot as jpeakplot
from hicpeaks_tpu.io.coolerlite import CoolerLite as JCoolerLite
from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu_torch.cli import apa as tapa
from hicpeaks_tpu_torch.cli import peakplot as tpeakplot
from hicpeaks_tpu_torch.io.coolerlite import CoolerLite as TCoolerLite

from .torch_threads import one_intra_op_thread  # noqa: F401

RES = 25000


@pytest.fixture(scope='module')
def plotdata(tmp_path_factory):
    """tests/test_reference_plots.py's cooler and loop list (260 bins at
    25 kb, seed 5, 14 loops, depth 80; the first 8 loops, chr-prefixed)."""
    root = tmp_path_factory.mktemp('plots')
    uri, loops = synthetic_cooler(str(root / 'p.cool'), n_bins=260, res=RES,
                                  seed=5, n_loops=14, depth=80.0)
    bedpe = root / 'loops.bedpe'
    with open(bedpe, 'w') as f:
        for x, y in loops[:8]:
            f.write(f'chr21\t{x * RES}\t{(x + 1) * RES}'
                    f'\tchr21\t{y * RES}\t{(y + 1) * RES}\n')
    return root, uri, str(bedpe)


def _pngs(root, jmain, tmain, argv, port_flags=()):
    j, t = root / 'jax.png', root / 'port.png'
    assert jmain(['-O', str(j), *argv]) == 0
    assert tmain(['-O', str(t), *argv, *port_flags]) == 0
    return j.read_bytes(), t.read_bytes()


@pytest.mark.parametrize('flags', [[], ['--clr-weight-name', 'raw',
                                        '-W', '3', '-C', '2']],
                         ids=['default', 'raw_w3'])
def test_apa_png_byte_identical(plotdata, tmp_path, capsys, flags):
    _, uri, bedpe = plotdata
    want, got = _pngs(tmp_path, japa.main, tapa.main,
                      ['-p', uri, '-I', bedpe, '-S', '0', '-M', '3',
                       '--dpi', '120', *flags], ('--device', 'cpu'))
    counts = capsys.readouterr().out.split()
    assert counts[0] == counts[1] and int(counts[0]) > 0
    assert got[:8] == b'\x89PNG\r\n\x1a\n'
    assert got == want


@pytest.mark.parametrize('flags', [[], ['--log', '--clr-weight-name', 'raw'],
                                   ['--nolabel', '--vmax', '3']],
                         ids=['default', 'log_raw', 'nolabel_vmax'])
def test_peakplot_png_byte_identical(plotdata, tmp_path, flags):
    _, uri, bedpe = plotdata
    want, got = _pngs(tmp_path, jpeakplot.main, tpeakplot.main,
                      ['-p', uri, '-I', bedpe, '-C', '21', '-S', '500000',
                       '-E', '4500000', '--dpi', '120', *flags])
    assert got[:8] == b'\x89PNG\r\n\x1a\n'
    assert got == want


@pytest.mark.parametrize('balance', ['weight', False])
def test_fetch_dense_region_equals_jax(plotdata, balance):
    _, uri, _ = plotdata
    for start, end in ((500000, 4500000), (0, 260 * RES), (37000, 101000)):
        got = TCoolerLite(uri).fetch_dense_region('21', start, end,
                                                  balance=balance)
        want = JCoolerLite(uri).fetch_dense_region('21', start, end,
                                                   balance=balance)
        assert got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=True)
