"""Traffic subsystem: replayable traces, load generators, SLO metrics,
and the named scenario registry for the diffusion serving engine; port of
``repro.serving.traffic``.

A workload is either a versioned JSONL trace (``trace``) or a seeded
generator (``generators``); ``metrics.MetricsCollector`` scores the run
against a ``metrics.SLO``; ``scenarios`` binds all three under stable
names the launcher (``--scenario``) iterates over; ``sim.SimClock`` is the
deterministic service clock for scheduler-policy studies.
"""
from repro_torch.serving.traffic.trace import (FORMAT, VERSION, TraceRequest,
                                               TraceWriter, load_trace,
                                               save_trace, submit_trace,
                                               validate_trace)
from repro_torch.serving.traffic.generators import (OPEN_LOOP,
                                                    ClosedLoopGenerator,
                                                    RequestMix,
                                                    open_loop_trace)
from repro_torch.serving.traffic.metrics import (SLO, MetricsCollector,
                                                 percentile)
from repro_torch.serving.traffic.scenarios import (SCENARIOS, Scenario,
                                                   build_trace, get_scenario,
                                                   list_scenarios,
                                                   run_scenario)
from repro_torch.serving.traffic.sim import SimClock
