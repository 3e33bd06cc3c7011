"""The harness names no model family: no file of ``portbench/harness/``
names FastSpeech, HiFi-GAN or Vocos, a model class of the port, or a field
of the FastSpeech 2 output; and no file of the benchmark but the family
files imports the port."""

import re

from portbench.tests import tiny

FAMILY_WORDS = re.compile(
    r"fastspeech|hifi-?gan|vocos|melgan|FastSpeech2Align|FastSpeech2Loss|"
    r"Synthesizer|duration_rounded|pitch_prediction|"
    r"energy_prediction", re.IGNORECASE)
PORT_IMPORT = re.compile(r"^\s*(from|import)\s+smart_nar_fast_tts_tpu_torch",
                         re.MULTILINE)


def test_harness_names_no_family():
    found = {}
    for path in sorted((tiny.ROOT / "harness").glob("*.py")):
        words = sorted({m.group(0) for m in FAMILY_WORDS.finditer(
            path.read_text())})
        if words:
            found[path.name] = words
    assert not found


def test_only_family_files_import_the_port():
    families = tiny.ROOT / "families"
    importers = [path.relative_to(tiny.ROOT) for path in
                 sorted(tiny.ROOT.rglob("*.py"))
                 if families not in path.parents
                 and PORT_IMPORT.search(path.read_text())]
    assert not importers
    assert any(PORT_IMPORT.search(path.read_text())
               for path in families.glob("*.py"))
