"""Write tests/data/fboot_logn6_jax.mft.gz: the JAX package's keys and
ciphertext of tests/test_fboot.py's bootstrap (the dense logN-6 session of
tests/test_torch_fboot.py) in its own wire format, gzipped, for the card's
test of the staged bootstrap (tests/test_torch_staged_cuda.py), where JAX
is absent.

    python tools/port_staged_fixture.py

JAX on the CPU, ~40 s (the JAX keygen of both sessions).
tests/test_torch_fboot.py holds the file to a fresh JAX session.
"""

from __future__ import annotations

import gzip
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main() -> None:
    import test_torch_fboot as t
    data = t.jax_blobs(t.jax_context().dense)
    t.FIXTURE.write_bytes(gzip.compress(data, mtime=0))
    print(f"{t.FIXTURE}: {len(data)} bytes, {t.FIXTURE.stat().st_size} gzipped")


if __name__ == "__main__":
    main()
