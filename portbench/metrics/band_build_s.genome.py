"""band_build_s.genome: the band builds of one genome call, in s: the sum
of the ``band build %.2fs`` that ``api._run`` logs for each chromosome,
over the traced calls."""
import re

_BUILD = re.compile(r'band build ([\d.]+)s')


def read(run):
    builds = [float(m.group(1)) for line in run.log
              for m in [_BUILD.search(line)] if m]
    if not builds or not run.walls:
        return None
    return sum(builds) / len(run.walls)
