"""The port's text frontend (its own copy of ``text/``) against the JAX
package's: the same symbol table and ids, cleaners, number expansion,
lexicon and G2P fallbacks, so the same sentence reaches both models as the
same ids.  Exact equality throughout: the code is the same and runs on the
host."""

import numpy as np
import pytest

from smart_nar_fast_tts_tpu import text as jax_text
from smart_nar_fast_tts_tpu.text import cleaners as jax_cleaners
from smart_nar_fast_tts_tpu.text import g2p as jax_g2p
from smart_nar_fast_tts_tpu.text import g2p_model as jax_g2p_model
from smart_nar_fast_tts_tpu.text.cmudict import CMUDict as JaxCMUDict
from smart_nar_fast_tts_tpu_torch import text as port_text
from smart_nar_fast_tts_tpu_torch.config import VOCAB_SIZE
from smart_nar_fast_tts_tpu_torch.text import cleaners as port_cleaners
from smart_nar_fast_tts_tpu_torch.text import g2p as port_g2p
from smart_nar_fast_tts_tpu_torch.text import g2p_model as port_g2p_model
from smart_nar_fast_tts_tpu_torch.text.cmudict import CMUDict

SENTENCES = [
    "Hello world.",
    "Dr. Smith paid $12.50 on the 3rd of May, 1999; Mrs. Jones paid £3.",
    "The 21st century began in 2001, not 2000!",
    "{HH AH0 L OW1} there, {W ER1 L D} again.",
    "Quixotic zyzzyvas flummoxed the bureaucratique gendarmes.",
    "Café naïve résumé — déjà vu?",
    "It's 4:30 pm, and 1,234,567 people said: 'no'.",
    "Capt. Lt. Col. St. Ft. 10th 100 1000000",
]
CLEANERS = ["english_cleaners"]


def test_symbol_table():
    assert port_text.SYMBOLS == jax_text.SYMBOLS
    assert port_text.SYMBOL_TO_ID == jax_text.SYMBOL_TO_ID
    assert port_text.VOCAB_SIZE == jax_text.VOCAB_SIZE == VOCAB_SIZE == 361
    assert port_text.PAD_ID == jax_text.PAD_ID


@pytest.mark.parametrize("sentence", SENTENCES)
def test_text_to_sequence_and_back(sentence):
    ids = port_text.text_to_sequence(sentence, CLEANERS)
    assert ids == jax_text.text_to_sequence(sentence, CLEANERS)
    assert port_text.sequence_to_text(ids) == jax_text.sequence_to_text(ids)
    assert port_cleaners.english_cleaners(sentence) == \
        jax_cleaners.english_cleaners(sentence)


@pytest.mark.parametrize("sentence", SENTENCES)
def test_g2p_and_ids(sentence):
    """Lexicon-free: OOV words go through the learned numpy G2P model on
    the committed weights (then the rule pass); with the committed seed
    lexicon as the lexicon, its words are looked up first."""
    for lexicon in ("", port_g2p_model.DEFAULT_SEED_LEXICON):
        phones = port_g2p.G2P(lexicon)(sentence)
        assert phones == jax_g2p.G2P(lexicon)(sentence)
        assert port_text.text_to_sequence(phones, CLEANERS) == \
            jax_text.text_to_sequence(phones, CLEANERS)


def test_g2p_model_reads_the_committed_files():
    assert port_g2p_model.DEFAULT_WEIGHTS.endswith(
        "smart_nar_fast_tts_tpu/text/data/g2p_weights.npz")
    model = port_g2p_model.load_default()
    assert model is not None
    with np.load(jax_g2p_model.DEFAULT_WEIGHTS) as z:
        assert sorted(z.files) == sorted(model.p)
    for word in ("zyzzyvas", "bureaucratique", "flummoxed"):
        assert model.predict(word) == jax_g2p_model.load_default().predict(
            word)


def test_phonemes_and_cmudict(tmp_path):
    phones = "HH AH0 L OW1 sp W ER1 L D spn sil"
    assert port_text.phonemes_to_sequence(phones) == \
        jax_text.phonemes_to_sequence(phones)
    path = tmp_path / "tiny.dict"
    path.write_text(";;; comment\nHELLO  HH AH0 L OW1\nHELLO(1)  HH EH0 L "
                    "OW1\nWORLD  W ER1 L D\nBAD  XX YY\n", encoding="latin-1")
    assert CMUDict(str(path)).as_lexicon() == \
        JaxCMUDict(str(path)).as_lexicon()
    assert port_g2p.G2P(str(path))("hello bad world") == \
        jax_g2p.G2P(str(path))("hello bad world")
