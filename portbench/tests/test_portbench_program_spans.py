"""The program's spans against the device trace (``harness/program_spans
.py``) on hand-built cases: kernels counted to the span open at their
launch, idle inside a span, launches per call, the idle gaps named after
program spans, the reduction of raw profiler events, and the readers."""

from types import SimpleNamespace

import pytest

from portbench.tests import tiny
from portbench.harness import cell, program_spans
from portbench.harness.program_spans import ProgramTrace, innermost
from portbench.harness.trace import WINDOW, Trace


def _serving() -> ProgramTrace:
    """Two stage A calls, 0-4 and 6-9; the second's kernel runs after the
    span has closed."""
    return ProgramTrace(
        window_s=12.0,
        kernels=[("enc", 0.5, 1.0, 0.2), ("var", 1.5, 2.0, 1.2),
                 ("dec", 2.5, 3.5, 2.4), ("voc", 4.0, 5.0, 3.9),
                 ("enc", 6.5, 7.0, 6.1), ("dec", 9.5, 10.0, 8.5),
                 ("other", 11.0, 11.5, None)],
        spans=[("tts.stage_a", 0.0, 4.0), ("tts.acoustic.text_encoder",
                                           0.1, 1.1),
               ("tts.acoustic.decoder", 2.3, 3.8),
               ("tts.stage_a", 6.0, 9.0), ("tts.acoustic.decoder", 8.0, 8.9)],
        harness=[("stage_a", 0.0, 4.0), ("stage_a", 6.0, 9.0),
                 ("host_copy", 9.0, 10.5)])


def test_kernel_counts_to_its_launching_span():
    p = _serving()
    # "dec" of the second call runs at 9.5-10.0, after the span's end 9.0
    names = [k for k, _, _ in p.launched_in("tts.stage_a")]
    assert names == ["enc", "var", "dec", "voc", "enc", "dec"]
    assert p.launches_per_call("tts.stage_a") == pytest.approx(3.0)
    assert p.launches_per_call("tts.acoustic.decoder") == pytest.approx(1.0)
    assert p.launches_per_call("tts.stage_b") is None
    # stage_b's kernel launched at 3.9 inside stage A counts to stage A
    by = p.by_span()
    assert by["tts.stage_a"]["launches"] == pytest.approx(1.5)
    assert by["tts.acoustic.decoder"]["launches"] == pytest.approx(1.0)
    assert by["tts.acoustic.decoder"]["device_ms"] == pytest.approx(750.0)
    assert by["tts.acoustic.text_encoder"]["calls"] == 1


def test_idle_inside_a_span():
    p = _serving()
    # call 1: 0-4 with kernels 0.5-1, 1.5-2, 2.5-3.5 busy: 2 s, idle 2;
    # call 2: 6-9 with 6.5-7 busy: idle 2.5
    assert p.idle_s("tts.stage_a") == pytest.approx([2.0, 2.5])
    assert p.mean_idle_ms("tts.stage_a") == pytest.approx(2250.0)
    assert p.mean_idle_ms("tts.stage_b") is None
    # the decoder's 2.3-3.8: busy 2.5-3.5
    assert p.idle_s("tts.acoustic.decoder") == pytest.approx([0.5, 0.9])


def test_idle_gaps_name_program_spans():
    p = _serving()
    gaps = dict(p.idle_gaps())
    # kernels cover 4.5 s of the 12; each gap goes by its middle: 0-0.5
    # to the encoder, 1-1.5 and 2-2.5 to stage A (past the encoder, before
    # the decoder), 3.5-4 and 7-9.5 to the decoders, 10-11 to the copy
    assert sum(gaps.values()) == pytest.approx(p.window_s - 4.5)
    assert gaps == {"tts.acoustic.text_encoder": pytest.approx(0.5),
                    "tts.stage_a": pytest.approx(1.0),
                    "tts.acoustic.decoder": pytest.approx(3.0),
                    "outside": pytest.approx(1.5 + 0.5),
                    "host_copy": pytest.approx(1.0)}
    assert len(p.idle_gaps(top=2)) == 2


def test_without_program_spans_the_attribution_is_unchanged():
    # test_portbench_trace.py's case: the same names and seconds
    t = Trace(window_s=10.0,
              kernels=[("conv", 0.0, 4.0), ("gemm", 4.0, 6.0),
                       ("conv", 8.0, 9.0)],
              spans=[("stage_b", 0.0, 7.0), ("host_copy", 6.5, 8.5),
                     ("stage_a", 7.5, 9.5)])
    p = ProgramTrace(t.window_s, [(n, s, e, s) for n, s, e in t.kernels],
                     [], t.spans)
    got, want = dict(p.idle_gaps()), dict(t.idle_gaps())
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(want[k]) for k in want)


def test_step_phases_per_step():
    # two steps; the backward's kernels launch from another thread, at
    # times inside the main thread's backward span
    p = ProgramTrace(
        window_s=10.0,
        kernels=[("fwd", 0.2, 1.2, 0.1), ("bwd", 1.3, 3.3, 1.25),
                 ("adam", 3.4, 3.5, 3.35), ("fwd", 5.2, 6.2, 5.1),
                 ("bwd", 6.3, 8.3, 6.25), ("adam", 8.4, 8.5, 8.35)],
        spans=[("tts.step", 0.0, 3.4), ("tts.step.forward", 0.05, 1.2),
               ("tts.step.backward", 1.2, 3.3),
               ("tts.step.optimizer", 3.3, 3.4),
               ("tts.step", 5.0, 8.4), ("tts.step.forward", 5.05, 6.2),
               ("tts.step.backward", 6.2, 8.3),
               ("tts.step.optimizer", 8.3, 8.4)])
    assert p.device_ms_per("tts.step.forward", "tts.step") == \
        pytest.approx(1000.0)
    assert p.device_ms_per("tts.step.backward", "tts.step") == \
        pytest.approx(2000.0)
    assert p.device_ms_per("tts.step.optimizer", "tts.step") == \
        pytest.approx(100.0)
    assert p.device_ms_per("tts.step.forward", "tts.stage_a") is None


def test_innermost_picks_the_shortest():
    spans = [("a", 0.0, 10.0), ("b", 2.0, 5.0), ("c", 3.0, 4.0),
             ("d", 12.0, 13.0)]
    assert innermost(spans, [1.0, 2.0, 3.5, 4.0, 5.0, 11.0, 13.0]) == \
        [0, 1, 2, 2, 1, None, 3]


class _Event:
    """The accessors of a kineto event that the reduction reads."""

    def __init__(self, name, dev, start, end, cid=0, annotation=False):
        self._v = (name, dev, start, end, cid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return SimpleNamespace(name=self._v[1])

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_reduce_reads_launches_by_correlation():
    ms = 1_000_000
    events = [
        _Event(WINDOW, "CPU", 100 * ms, 1100 * ms, annotation=True),
        _Event("tts.stage_a", "CPU", 200 * ms, 400 * ms, 1, True),
        # its device mirror: not a kernel
        _Event("tts.stage_a", "CUDA", 250 * ms, 450 * ms, 1, True),
        _Event("aten::add", "CPU", 210 * ms, 230 * ms, 7),
        _Event("cudaLaunchKernel", "CPU", 220 * ms, 225 * ms, 7),
        _Event("add_kernel", "CUDA", 500 * ms, 600 * ms, 7),
        _Event("cudaMemcpyAsync", "CPU", 300 * ms, 301 * ms, 8),
        _Event("Memcpy DtoH", "CUDA", 1050 * ms, 1200 * ms, 8),
        # no launch call in the trace; one outside the window
        _Event("nccl_kernel", "CUDA", 700 * ms, 800 * ms, 9),
        _Event("early", "CUDA", 10 * ms, 20 * ms, 10),
    ]
    p = program_spans.reduce(events, harness=[("stage_a", 0.1, 0.3)])
    assert p.window_s == pytest.approx(1.0)
    assert p.spans == [("tts.stage_a", pytest.approx(0.1),
                        pytest.approx(0.3))]
    assert [(k, pytest.approx(s), pytest.approx(e),
             None if t is None else pytest.approx(t))
            for k, s, e, t in p.kernels] == [
        ("add_kernel", 0.4, 0.5, 0.12), ("Memcpy DtoH", 0.95, 1.0, 0.2),
        ("nccl_kernel", 0.6, 0.7, None)]
    assert p.harness == [("stage_a", 0.1, 0.3)]
    assert p.launches_per_call("tts.stage_a") == pytest.approx(2.0)


NEW = {"stage_a_idle_ms.serve": 2250.0, "stage_a_idle_ms.online": 2250.0,
       "stage_a_launches.serve": 3.0}


@pytest.mark.parametrize("name", sorted(NEW))
def test_serving_readers(name, monkeypatch):
    read = cell.metric_reader(name)
    monkeypatch.setattr(program_spans, "of", lambda run: _serving())
    assert read(None) == pytest.approx(NEW[name])
    monkeypatch.setattr(program_spans, "of", lambda run: None)
    assert read(None) is None


@pytest.mark.parametrize("phase", ["forward", "backward", "optimizer"])
def test_train_readers(phase, monkeypatch):
    read = cell.metric_reader(f"{phase}_ms.train")
    p = ProgramTrace(2.0, [("k", 0.2, 0.7, 0.1)],
                     [("tts.step", 0.0, 1.0), (f"tts.step.{phase}", 0.0,
                                               0.5)])
    monkeypatch.setattr(program_spans, "of", lambda run: p)
    assert read(None) == pytest.approx(500.0)
    monkeypatch.setattr(program_spans, "of", lambda run: None)
    assert read(None) is None


def test_traced_run_finds_the_window(monkeypatch):
    """In a traced run the readers find the profiler that made the trace
    and the program's spans in it; on the CPU there is no kernel, so every
    new metric is left out."""
    seen = []
    original = cell.metric_reader

    def spy(name):
        def read(run):
            tracer = program_spans._tracer_of(run.trace)
            seen.append(program_spans.reduce(
                tracer.prof.profiler.kineto_results.events()))
            return original(name)(run)
        return read
    monkeypatch.setattr(cell, "metric_reader", spy)
    r = tiny.run("fs2_hifigan_v1.online", trace=True, seconds=0.4)
    assert seen
    names = {n for n, _, _ in seen[0].spans}
    assert {"tts.synthesize", "tts.stage_a", "tts.bucket", "tts.stage_b",
            "tts.acoustic.variance", "tts.acoustic.upsample"} <= names
    assert seen[0].kernels == []
    assert "stage_a_idle_ms.online" not in r["metrics"]
    assert program_spans._tracer_of(Trace(1.0, [])) is None
