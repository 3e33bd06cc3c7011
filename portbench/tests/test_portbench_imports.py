"""What the benchmark loads: never JAX, flax or the JAX package (whole
top-level names: the port's name begins with the JAX package's), neither
in a run nor through any family file; the reference, and the family files
until they build the program, load nothing of the port; no file of the
benchmark reads the JAX package's benchmark."""

import subprocess
import sys

from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "smart_nar_fast_tts_tpu"}
PORT = "smart_nar_fast_tts_tpu_torch"


def _top_level(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_run_loads_no_jax():
    """A serving and a training run, and every family's vocoder built."""
    mods = _top_level(
        "from portbench.tests import tiny\n"
        "from portbench.harness import families\n"
        "tiny.run('fs2_hifigan_v1.batch', seconds=0.3)\n"
        "tiny.run('fs2_hifigan_v1.train', seconds=0.3)\n"
        "for name in ('fs2_hifigan_v1', 'fastspeech_vocos'):\n"
        "    v = tiny.config(name)['vocoder']\n"
        "    fam = families.of(tiny.config(name))[1]\n"
        "    fam.build(v, fam.draw(v, 1, 'cpu'))")
    assert PORT in mods
    assert not mods & FORBIDDEN


def test_reference_loads_no_port():
    """The reference, and every family file as loaded."""
    mods = _top_level(
        "import portbench.reference.fastspeech2, portbench.reference.hifigan"
        ", portbench.reference.vocos, portbench.reference.train\n"
        "from portbench.harness import families\n"
        "for path in sorted(families.FAMILY_DIR.glob('*.py')):\n"
        "    families.load(path.stem)")
    assert not mods & (FORBIDDEN | {PORT})


def test_no_file_reads_the_jax_benchmark():
    names = ("bench" + ".py", "bench" + "marks/", "BENCH" + "_r0",
             "BASE" + "LINE.json")
    for path in tiny.ROOT.rglob("*"):
        if path.suffix in (".py", ".json") and "tests" not in path.parts:
            text = path.read_text()
            assert not any(n in text for n in names), path
