"""Project-native invariant linter of the PyTorch/CUDA port (the port
of ``chunky_bits_tpu/analysis``).

The invariants that keep the port correct live in prose (the JAX
package's CLAUDE.md and ROADMAP.md's rules for the port); this package
makes them machine-checked.  Pure stdlib ``ast``/``tokenize`` —
importing it never pulls torch, numpy, or aiohttp, so the gate runs on
a box with no card and in bare CI runners.  Its rules and their scopes
are the reference's, on the port's tree; CB102 watches the port's own
``CHUNKY_BITS_TORCH_*`` prefix and CB105 the port's kernel launches.

Invariant -> rule (suppression slug in backticks — the exact token the
``# lint: <slug>-ok <reason>`` marker takes; each rule's docstring
carries the full story):

- never hang (bounded device/network waits)         -> CB101
  ``unbounded-await``
- env flags read once, at first dispatch            -> CB102
  ``env-read``
- workers parked in a device call block exit        -> CB103
  ``thread``
- degraded-mode fallbacks must not eat corruption     -> CB104
  ``broad-except``
- kernel launches: dense tensors behind every
  ``data_ptr()``, every return code checked, no
  in-place write through ``torch.from_numpy``        -> CB105
  ``launch-hygiene``
- strict typing on the public compute/serve surfaces  -> CB106
  ``annotations``

CB2xx — concurrency hazards of the two-plane host/async runtime
(concurrency.py; ``--select CB2`` runs the family alone):

- the event loop must never execute blocking sync I/O -> CB201
  ``async-blocking``
- threading locks must not be held across awaits      -> CB202
  ``lock-across-await``
- every spawned task needs an owner                   -> CB203
  ``task-leak``
- worker code re-enters the loop only through the
  _threadsafe doors (call-graph pass, callgraph.py)   -> CB204
  ``cross-plane``
- serve-path singletons are per-event-loop            -> CB205
  ``loop-shared``

CB3xx — whole-program reachability (flow.py over the shared
function-granular call graph in callgraph.py + reachability.py;
``--select CB3`` runs the family alone; ``--explain CB3xx`` prints any
rule's full rationale, ``--graph-stats`` reports graph precision):

- crash harness replays only seam-recorded mutations:
  no durability op off-seam anywhere a durability root
  (slab append/compact, publish, metadata write,
  repair rewrite) can reach                           -> CB301
  ``fsio-escape``
- same seed => byte-identical trace: no wall-clock
  read anywhere a sim scenario can reach              -> CB302
  ``clock-escape``
- cancellation must propagate (never swallowed),
  complete (cancel() is awaited), and never strand a
  write->replace publish window                       -> CB303
  ``cancel-safety``
- production planes import NOTHING from sim/ — proven
  statically incl. lazy in-function imports (the
  runtime subprocess pin in tests/test_torch_sim.py covers
  the default import closure; both stay)              -> CB304
  ``sim-purity``
- closed-set metric labels hold at the CALL SITES of
  functions that feed parameters into ``.labels()``   -> CB305
  ``label-flow``

CB4xx — resource lifetime & deadline propagation (lifetime.py over
statement-granular CFGs from cfg.py: explicit exception/finally/
with-unwind edges plus await-as-cancellation-point edges, a worklist
may/must dataflow engine, per-function summaries composed through the
shared call graph; ``--select CB4`` runs the family alone):

- leak-strict extends to EVERY path out of a function:
  an acquired fd/socket/mmap is closed, returned,
  stored, or handed off even when a statement between
  acquire and release raises or is cancelled          -> CB401
  ``fd-leak``
- a manual lock/flock acquire reaches its release on
  all paths (an exception between them deadlocks
  every later taker)                                  -> CB402
  ``lock-discipline``
- CFG-precise task custody: an ASSIGNED task can
  still lose its owner when the path between spawn
  and await raises; cancel() alone observes nothing   -> CB403
  ``task-custody``
- degrade-never-hang, interprocedurally: serving-
  plane paths into modules off CB101's list still
  need a deadline at SOME frame (wait_for at the
  call site bounds everything beneath)                -> CB404
  ``unbounded-deadline``
- scrub/repair I/O is exactly metered: every read/
  write dominated by its own bucket.take() charge,
  caller-side charges compose through summaries       -> CB405
  ``metered-io``

The runtime side of the same contract lives in ``sanitizer.py``: an
opt-in (``$CHUNKY_BITS_TORCH_SANITIZE``) loop-stall watchdog, task-leak
registry, and HostPipeline handoff checker.  It is deliberately NOT
imported here — the off path must never load instrumentation (and this
package must keep importing clean on a bare interpreter).

Entry point: ``python -m chunky_bits_tpu_torch.analysis`` (scans
``chunky_bits_tpu_torch/`` against ``analysis/baseline.toml``; the
tests in tests/test_torch_analysis.py run it whole).  Violations
are suppressed inline with ``# lint: <slug>-ok <reason>`` (the reason is
mandatory) or recorded in ``analysis/baseline.toml`` so pre-existing
findings stay green while NEW violations fail the gate.
"""

from chunky_bits_tpu_torch.analysis.core import (  # noqa: F401
    Violation,
    load_baseline,
    run_analysis,
    write_baseline,
)
from chunky_bits_tpu_torch.analysis.rules import ALL_RULES  # noqa: F401
