"""The port's Qwen2 tokenizer against the ``tokenizers`` package (CPU).

The published Qwen2 vocabulary (``tokenizer.json`` / ``vocab.json`` +
``merges.txt`` of Qwen/Qwen2-0.5B) is not in the repository, so parity on it
waits for that file. Here a byte-level BPE of about 3000 tokens is trained in
the test with ``tokenizers.trainers.BpeTrainer``, on the JAX package's
pre-tokenizer (its ``PRETOKENIZE_REGEX`` split, then ByteLevel) and with the
Qwen2 special tokens, and written out three ways: ``tokenizer.json`` with
its merges as ``[a, b]`` pairs (what ``tokenizers`` 0.22 writes), the same
with ``"a b"`` strings (what older versions wrote), and ``vocab.json`` +
``merges.txt`` + ``tokenizer_config.json`` in the Qwen2 layout (the special
tokens past the vocabulary). On each, the JAX package's ``TextTokenizer``
(which runs ``tokenizers``) and the port's give the same ids from
``encode``, ``encode_for_tts`` and ``encode_padded`` and the same text from
``decode``, on a fixed corpus (each string a case) and on random text of
letters, numbers, punctuation and spaces (hypothesis, a fixed seed).
"""

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

from qwen3_tts_tpu.tokenizer import PRETOKENIZE_REGEX
from qwen3_tts_tpu.tokenizer import TextTokenizer as JTokenizer
from qwen3_tts_tpu_torch import tokenizer as port_tokenizer
from qwen3_tts_tpu_torch.tokenizer import TextTokenizer

SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
CORPUS = [
    "Hello world! It's a test, isn't it? I'LL see what THEY'RE doing; we'd've gone.",
    "She'S here, you'Re there: don't, WON'T, can't, I'm, I'M, we'll, WE'D.",
    "Numbers: 7, 42, 1234567890, 3.14159, -2.5e10, 100,000,000 and 0x1F.",
    "Punctuation runs!!! ??? ... --- ;;; ((())) [[[]]] {{}} ***&&&%%%$$$###@@@",
    "line one\r\nline two\n\nline three\r\n\r\n   indented    spaces     and\ttabs\t\t.",
    "Decomposed accents: café naïve résumé Ångström.",
    "Composed accents: café naïve résumé Ångström.",
    "中文文本：你好，世界！日本語のテキスト。한국어 텍스트.",
    "Emoji 🙂👍🏽 and 👨‍👩‍👧‍👦 families, flags 🇯🇵, symbols ★☆♥.",
    "<|im_start|>user\nSay hello.<|im_end|>\n<|im_start|>assistant\n",
    "Inline <|endoftext|>special<|im_end|>tokens<|im_start|> mid-text.",
    "Trailing spaces   ",
    "   Leading spaces",
    " non-breaking thin　ideographic line sep",
    "Mixed: ABC123def456 ١٢٣ ⅠⅡ ½ ²",
    "",
]


def _training_text(n: int = 4000, seed: int = 0) -> list[str]:
    """Seeded sentences over a small lexicon, with numbers and punctuation."""
    rs = np.random.RandomState(seed)
    syllables = [c + v for c in "bcdfghjklmnprstvwz" for v in ("a", "e", "i", "o", "u", "ou", "ea", "é")]
    words = ["".join(rs.choice(syllables, rs.randint(1, 4))) for _ in range(1500)]
    words += "the quick brown fox it's don't we'll i'm you're 中文 日本語 한국어 ñandú Ölfeld straße".split()
    out = []
    for _ in range(n):
        k = rs.randint(3, 14)
        s = " ".join(words[i] for i in rs.randint(0, len(words), k))
        out.append(s.capitalize() + rs.choice([".", "!", "?", ",", " 123.", "..."]) + rs.choice(["", "\n", "\r\n"]))
    return out + CORPUS


def _train() -> Tokenizer:
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(pattern=Regex(PRETOKENIZE_REGEX), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=3000, show_progress=False, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=[AddedToken(t, special=True, normalized=False) for t in SPECIALS],
    )
    tok.train_from_iterator(_training_text(), trainer)
    return tok


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{path kind: tokenizer source} for the three ways the trained BPE is written."""
    root = tmp_path_factory.mktemp("tok")
    tok = _train()
    spec = json.loads(tok.to_str())
    assert spec["model"]["merges"] and isinstance(spec["model"]["merges"][0], list)
    (root / "pairs").mkdir()
    (root / "pairs" / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    strings = json.loads(json.dumps(spec))
    strings["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    (root / "strings.json").write_text(json.dumps(strings), encoding="utf-8")
    # The Qwen2 layout: the special tokens out of vocab.json, the ids closed up.
    slow = root / "slow"
    slow.mkdir()
    vocab = {t: i for t, i in sorted(spec["model"]["vocab"].items(), key=lambda kv: kv[1]) if t not in SPECIALS}
    vocab = {t: n for n, t in enumerate(vocab)}
    (slow / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (slow / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in spec["model"]["merges"]),
                                     encoding="utf-8")
    added = {str(len(vocab) + i): {"content": t, "lstrip": False, "normalized": False, "rstrip": False,
                                   "single_word": False, "special": True} for i, t in enumerate(SPECIALS)}
    (slow / "tokenizer_config.json").write_text(json.dumps({"added_tokens_decoder": added}), encoding="utf-8")
    return {"tokenizer.json pairs": root / "pairs", "tokenizer.json strings": root / "strings.json",
            "vocab.json + merges.txt": slow}


_PAIRS = {}


def pair(files, kind: str) -> tuple:
    """(JAX tokenizer, port tokenizer) from the same files."""
    if kind not in _PAIRS:
        _PAIRS[kind] = (JTokenizer.from_pretrained(files[kind]), TextTokenizer.from_pretrained(files[kind]))
    return _PAIRS[kind]


KINDS = ["tokenizer.json pairs", "tokenizer.json strings", "vocab.json + merges.txt"]


def check_text(j: JTokenizer, t: TextTokenizer, text: str) -> None:
    ids = j.encode(text)
    assert t.encode(text) == ids
    assert t.encode_for_tts(text) == j.encode_for_tts(text)
    for n in (4, 64):
        assert t.encode_padded(text, n) == j.encode_padded(text, n)
    assert t.decode(ids) == j.decode(ids)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("index", range(len(CORPUS)))
def test_corpus_matches_tokenizers(files, kind, index):
    check_text(*pair(files, kind), CORPUS[index])


@pytest.mark.parametrize("kind", KINDS)
def test_vocabulary_and_special_ids(files, kind):
    j, t = pair(files, kind)
    assert 2900 <= t.vocab_size() == j.vocab_size() <= 3003
    assert (t.bos_token_id, t.eos_token_id, t.pad_token_id) == (j.bos_token_id, j.eos_token_id, j.pad_token_id)
    for tok in SPECIALS + ("Ġthe", "he", "not-a-token"):
        assert t.token_to_id(tok) == j.token_to_id(tok)
    for i in (0, 1, 2, 255, 1000, t.vocab_size() - 1, t.vocab_size() + 5):
        assert t.id_to_token(i) == j.id_to_token(i)
    assert t.encode_with_special("hi") == j.encode_with_special("hi")
    assert t.encode_chat("hi", "system") == j.encode_chat("hi", "system")
    assert t.encode_batch(CORPUS[:4]) == j.encode_batch(CORPUS[:4])


TEXT = st.text(
    alphabet=st.characters(categories=("L", "N", "P", "Z")) | st.sampled_from(" \t\n\r'"), max_size=48)


@settings(max_examples=150, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT)
@pytest.mark.parametrize("kind", ["tokenizer.json pairs", "vocab.json + merges.txt"])
def test_random_text_matches_tokenizers(files, kind, text):
    check_text(*pair(files, kind), text)


@settings(max_examples=100, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ids=st.lists(st.integers(0, 3010), max_size=24))
def test_random_ids_decode_as_tokenizers(files, ids):
    """Any id sequence: specials skipped, unknown ids dropped, bytes that are
    not UTF-8 replaced as ``tokenizers`` replaces them."""
    j, t = pair(files, "tokenizer.json pairs")
    assert t.decode(ids) == j.decode(ids)


@pytest.mark.parametrize("text", ["a\x1cb\x1d c", "x \x1e\x1f y", "p\u3000q\u2028r", "a\xa0\xa0b", "t\t\tend  ",
                                  "\x85n\u200bo\u180ep"])
def test_split_regex_matches_tokenizers(text):
    """The split regex's pieces are the ``tokenizers`` package's: its ``\\s``
    is Unicode White_Space, not Python's ``str.isspace`` (which also holds
    U+001C..U+001F)."""
    split = pre_tokenizers.Split(pattern=Regex(PRETOKENIZE_REGEX), behavior="isolated", invert=False)
    assert port_tokenizer.split_pattern().findall(text) == [p for p, _ in split.pre_tokenize_str(text)]


@pytest.mark.parametrize("change", [
    ("normalizer", {"type": "NFKC"}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("model.ignore_merges", True),
    ("model.byte_fallback", True),
    ("model.dropout", 0.1),
], ids=lambda c: c[0] if isinstance(c, tuple) else str(c))
def test_refuses_other_pipelines(files, tmp_path, change):
    spec = json.loads((files["tokenizer.json pairs"] / "tokenizer.json").read_text(encoding="utf-8"))
    key, value = change
    node = spec
    *parents, leaf = key.split(".")
    for p in parents:
        node = node[p]
    node[leaf] = value
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec), encoding="utf-8")
    with pytest.raises(ValueError, match="not the Qwen2"):
        TextTokenizer.from_pretrained(path)


def test_refuses_hub_ids_and_empty_dirs(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not download"):
        TextTokenizer.from_pretrained("Qwen/Qwen2-0.5B")
    with pytest.raises(FileNotFoundError, match="No tokenizer files"):
        TextTokenizer.from_pretrained(tmp_path)


def test_added_token_flags_match_tokenizers(tmp_path):
    """lstrip / rstrip / single_word / normalized added tokens on a small
    byte-level vocabulary, against ``tokenizers`` with the same tokens."""
    tok = _train()
    extra = [AddedToken("<mark>", special=True, lstrip=True, rstrip=True, normalized=False),
             AddedToken("word", special=True, single_word=True, normalized=False),
             AddedToken("café", special=True, normalized=True)]
    tok.add_special_tokens(extra)
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    j, t = JTokenizer.from_file(path), TextTokenizer.from_file(path)
    for text in ("a  <mark>  b", "<mark>x<mark>", "word words sword word_ (word)", "café café x", "  <mark>"):
        assert t.encode(text) == j.encode(text), text
        assert t.decode(t.encode(text)) == j.decode(j.encode(text)), text
