"""Precision clock fault helpers (``jepsen/nemesis/time.clj``).

The reference uploads and compiles two tiny C programs on each node —
one bumps the clock by a millisecond offset, one strobes it between two
values at high frequency — then drives them over SSH. We ship equivalent
C sources (written fresh for this framework) and the same install/drive
API.

The counterpart of the JAX package's ``harness/nemesis_time.py``: host
code, the same C helpers and commands (installed where the JAX
package installs them).
"""

from __future__ import annotations

import os
import tempfile

from .. import control

# minimal C helpers; installed to /opt/comdb2_tpu/ on each node
BUMP_TIME_C = r"""
/* bump-time: shift CLOCK_REALTIME by <ms> milliseconds. */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

int main(int argc, char **argv) {
  if (argc != 2) { fprintf(stderr, "usage: %s ms\n", argv[0]); return 2; }
  long long ms = atoll(argv[1]);
  struct timespec ts;
  if (clock_gettime(CLOCK_REALTIME, &ts)) { perror("gettime"); return 1; }
  long long ns = ts.tv_nsec + (ms % 1000) * 1000000LL;
  ts.tv_sec += ms / 1000 + ns / 1000000000LL;
  ts.tv_nsec = ns % 1000000000LL;
  if (ts.tv_nsec < 0) { ts.tv_nsec += 1000000000LL; ts.tv_sec -= 1; }
  if (clock_settime(CLOCK_REALTIME, &ts)) { perror("settime"); return 1; }
  return 0;
}
"""

STROBE_TIME_C = r"""
/* strobe-time: flip CLOCK_REALTIME between now and now+<delta>ms every
   <period>ms for <duration>ms. */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include <unistd.h>

int main(int argc, char **argv) {
  if (argc != 4) {
    fprintf(stderr, "usage: %s delta_ms period_ms duration_ms\n", argv[0]);
    return 2;
  }
  long long delta = atoll(argv[1]), period = atoll(argv[2]),
            duration = atoll(argv[3]);
  struct timespec t0;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  int up = 0;
  for (;;) {
    struct timespec now_m;
    clock_gettime(CLOCK_MONOTONIC, &now_m);
    long long elapsed = (now_m.tv_sec - t0.tv_sec) * 1000LL
                      + (now_m.tv_nsec - t0.tv_nsec) / 1000000LL;
    if (elapsed >= duration) break;
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    long long d = up ? -delta : delta;
    up = !up;
    long long ns = ts.tv_nsec + (d % 1000) * 1000000LL;
    ts.tv_sec += d / 1000 + ns / 1000000000LL;
    ts.tv_nsec = ns % 1000000000LL;
    if (ts.tv_nsec < 0) { ts.tv_nsec += 1000000000LL; ts.tv_sec -= 1; }
    clock_settime(CLOCK_REALTIME, &ts);
    usleep(period * 1000);
  }
  return 0;
}
"""

INSTALL_DIR = "/opt/comdb2_tpu"


def install(install_dir: str = INSTALL_DIR) -> None:
    """Upload + compile the helpers on the current session's node
    (``nemesis/time.clj:8-24``)."""
    control.su("mkdir", "-p", install_dir)
    for name, src in (("bump-time", BUMP_TIME_C),
                      ("strobe-time", STROBE_TIME_C)):
        with tempfile.NamedTemporaryFile("w", suffix=".c",
                                         delete=False) as fh:
            fh.write(src)
            local = fh.name
        try:
            control.upload(local, f"/tmp/{name}.c")
        finally:
            os.unlink(local)
        control.su("cc", "-O2", "-o", f"{install_dir}/{name}",
                   f"/tmp/{name}.c", "-lrt")


def bump_time(ms: float, install_dir: str = INSTALL_DIR) -> None:
    """Shift the clock by ms on the current node
    (``nemesis/time.clj:32-38``)."""
    control.su(f"{install_dir}/bump-time", str(int(ms)))


def strobe_time(delta_ms: float, period_ms: float, duration_s: float,
                install_dir: str = INSTALL_DIR) -> None:
    """Strobe the clock (``nemesis/time.clj:40-48``)."""
    control.su(f"{install_dir}/strobe-time", str(int(delta_ms)),
               str(int(period_ms)), str(int(duration_s * 1000)))


def reset_time() -> None:
    """Re-sync with NTP (``nemesis/time.clj:26-30``)."""
    control.su("ntpdate", "-p", "1", "-b", "pool.ntp.org", check=False)
