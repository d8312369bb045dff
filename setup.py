from setuptools import setup, find_packages
import hicpeaks_tpu

setup(
    name='hicpeaks-tpu',
    version=hicpeaks_tpu.__version__,
    description='TPU-native Hi-C loop calling (HiCCUPS / BH-FDR) on JAX',
    # hicpeaks_tpu (JAX) and hicpeaks_tpu_torch (PyTorch/CUDA port); the
    # port's CUDA sources are built with nvcc at first use
    packages=find_packages(exclude=['tests', 'tests.*']),
    package_data={'hicpeaks_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    scripts=['scripts/toCooler', 'scripts/pyBHFDR', 'scripts/pyHICCUPS',
             'scripts/combine-resolutions', 'scripts/peak-plot',
             'scripts/apa-analysis'],
    python_requires='>=3.10',
    install_requires=['numpy', 'scipy', 'h5py', 'jax'],
)
