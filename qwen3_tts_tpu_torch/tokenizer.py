"""Text tokenizer: the Qwen2 byte-level BPE in plain Python.

The same function as ``qwen3_tts_tpu/tokenizer.py``, which runs the HF
``tokenizers`` package, without that package (the GPU machines have neither
it nor ``regex``). The pipeline is the one the JAX package's
``from_vocab_and_merges`` builds:

  1. split out the added (special) tokens, honouring ``lstrip``,
     ``rstrip``, ``single_word`` and ``normalized``: the tokens with
     ``normalized=False`` are matched on the raw text, the others after NFC;
  2. NFC (``unicodedata.normalize``);
  3. the Qwen2 split regex ``PRETOKENIZE_REGEX``, every match and every gap
     its own piece ("isolated");
  4. GPT-2's byte-to-unicode map of each piece's UTF-8 bytes;
  5. BPE by merge rank (lowest rank first, then leftmost), with a cache;
  6. for decoding, the ByteLevel decoder, special tokens skipped.

Python's ``re`` has no ``\\p{L}`` / ``\\p{N}``, and its ``\\s`` also matches
U+001C..U+001F, which the ``tokenizers`` package's regex engine does not:
the three classes are built once, at first use, from
``unicodedata.category`` (letters ``L*``; numbers ``Nd``, ``Nl``, ``No``)
and the Unicode ``White_Space`` list, as ``[...]`` ranges.

Resolution order is the JAX package's: a ``tokenizer.json`` file, a
directory holding one, then ``vocab.json`` + ``merges.txt`` (+
``tokenizer_config.json``'s special ``added_tokens_decoder`` entries). A Hub
id raises ``FileNotFoundError``: nothing is downloaded. A ``tokenizer.json``
whose normalizer, pre-tokenizer, model or decoder is not the Qwen2
pipeline's raises ``ValueError`` rather than tokenizing differently.
"""

from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from pathlib import Path

# The Qwen2 pre-tokenization regex, as the ``tokenizers`` package runs it.
PRETOKENIZE_REGEX = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

# The Hub id of the Qwen2 vocabulary the JAX package falls back to; here a
# name only: ``TextTokenizer`` reads local files, and a Hub id raises.
DEFAULT_TOKENIZER_REPO = "Qwen/Qwen2-0.5B"

# Unicode White_Space: what ``\s`` matches in the ``tokenizers`` package.
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680), (0x2000, 0x200A),
                (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
_WS_CHARS = frozenset(chr(c) for lo, hi in _WHITE_SPACE for c in range(lo, hi + 1))


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {c: b for b, c in _BYTE_ENCODER.items()}


def _ranges(pairs) -> str:
    """``[...]`` class body of (lo, hi) code-point ranges."""
    return "".join(re.escape(chr(lo)) if lo == hi else f"{re.escape(chr(lo))}-{re.escape(chr(hi))}" for lo, hi in pairs)


def _category_ranges(prefixes: tuple[str, ...]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for c in range(sys.maxunicode + 1):
        if unicodedata.category(chr(c)).startswith(prefixes):
            if out and out[-1][1] == c - 1:
                out[-1][1] = c
            else:
                out.append([c, c])
    return [(lo, hi) for lo, hi in out]


@functools.cache
def split_pattern() -> re.Pattern:
    """``PRETOKENIZE_REGEX`` for Python's ``re``, its classes spelled out."""
    letters = _ranges(_category_ranges(("L",)))
    numbers = _ranges(_category_ranges(("Nd", "Nl", "No")))
    ws = _ranges(_WHITE_SPACE)
    return re.compile(
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
        rf"|[^\r\n{letters}{numbers}]?[{letters}]+"
        rf"|[{numbers}]"
        rf"| ?[^{ws}{letters}{numbers}]+[\r\n]*"
        rf"|[{ws}]*[\r\n]+"
        rf"|[{ws}]+(?![^{ws}])"
        rf"|[{ws}]+"
    )


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


class TextTokenizer:
    """Qwen2 byte-level BPE: ``vocab`` {token: id}, ``merges`` [(a, b)] in
    rank order, ``added`` the added tokens (dicts with ``id``, ``content``,
    ``special``, ``lstrip``, ``rstrip``, ``single_word``, ``normalized``),
    ``unk_token`` the model's unknown token (used for a character outside
    the vocabulary, which a byte-level vocabulary never has)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]], added: list[dict],
                 unk_token: str | None = None):
        self.vocab = dict(vocab)
        self._id_to_vocab = {i: t for t, i in self.vocab.items()}
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
            except KeyError as e:
                raise ValueError(f"merge {rank} ({a!r} {b!r}) names a token outside the vocabulary: {e}") from None
        self.unk_token = unk_token
        self.added = [dict(t) for t in added]
        self._added_by_content = {t["content"]: t for t in self.added}
        self._added_by_id = {t["id"]: t for t in self.added}
        self._special_ids = {t["id"] for t in self.added if t.get("special", False)}
        self._raw_split = self._matcher([t for t in self.added if not t.get("normalized", False)], raw=True)
        self._norm_split = self._matcher([t for t in self.added if t.get("normalized", False)], raw=False)
        self._cache: dict[str, list[int]] = {}

        def _tid(token: str, fallback: int) -> int:
            tid = self.token_to_id(token)
            return tid if tid is not None else fallback

        self.bos_token_id = _tid("<|im_start|>", 151644)
        self.eos_token_id = _tid("<|im_end|>", 151645)
        self.pad_token_id = _tid("<|endoftext|>", 151643)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_pretrained(cls, source: str | Path) -> "TextTokenizer":
        path = Path(source)
        if path.is_file():
            return cls.from_file(path)
        if (path / "tokenizer.json").exists():
            return cls.from_file(path / "tokenizer.json")
        if (path / "vocab.json").exists() and (path / "merges.txt").exists():
            return cls.from_vocab_and_merges(path)
        if path.is_dir():
            raise FileNotFoundError(
                f"No tokenizer files found in '{source}'. Expected tokenizer.json or vocab.json + merges.txt."
            )
        raise FileNotFoundError(
            f"No local tokenizer at '{source}'; this package does not download from the Hub: "
            "pass a tokenizer.json or a directory with vocab.json + merges.txt."
        )

    @classmethod
    def from_file(cls, path: str | Path) -> "TextTokenizer":
        """A ``tokenizer.json`` of the Qwen2 pipeline; any other raises."""
        spec = json.loads(Path(path).read_text(encoding="utf-8"))
        _check_qwen2(spec, path)
        model = spec["model"]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model.get("merges", [])]
        if any(len(m) != 2 for m in merges):
            raise ValueError(f"{path}: a merge is not a pair")
        return cls(model["vocab"], merges, spec.get("added_tokens") or [], model.get("unk_token"))

    @classmethod
    def from_vocab_and_merges(cls, directory: str | Path) -> "TextTokenizer":
        """The Qwen2 pipeline from slow-tokenizer files: ``vocab.json``,
        ``merges.txt`` and, if present, ``tokenizer_config.json``'s special
        tokens, each given its id in the vocabulary or the next free one."""
        directory = Path(directory)
        vocab = json.loads((directory / "vocab.json").read_text(encoding="utf-8"))
        merges = []
        for n, line in enumerate((directory / "merges.txt").read_text(encoding="utf-8").splitlines(), 1):
            if line.startswith("#version"):
                continue
            parts = line.split(" ")
            if len(parts) != 2:
                raise ValueError(f"{directory / 'merges.txt'}: line {n} is not a merge pair: {line!r}")
            merges.append((parts[0], parts[1]))
        added: list[dict] = []
        config_path = directory / "tokenizer_config.json"
        if config_path.exists():
            added = _special_tokens_from_config(vocab, json.loads(config_path.read_text(encoding="utf-8")))
        return cls(vocab, merges, added, unk_token="<|endoftext|>")

    # -- encode / decode -----------------------------------------------------

    @staticmethod
    def _matcher(tokens: list[dict], raw: bool):
        """Leftmost-longest matcher of the added tokens' contents."""
        contents = sorted({t["content"] if raw else unicodedata.normalize("NFC", t["content"]) for t in tokens},
                          key=lambda c: (-len(c), c))
        contents = [c for c in contents if c]
        if not contents:
            return None
        return re.compile("|".join(re.escape(c) for c in contents)), {
            (t["content"] if raw else unicodedata.normalize("NFC", t["content"])): t for t in tokens}

    def _split_added(self, text: str, matcher) -> list:
        """Pieces of ``text``: (token dict, None) for an added token, (None,
        str) for the text between them."""
        if matcher is None:
            return [(None, text)]
        pattern, by_content = matcher
        pieces, start_offset = [], 0
        for m in pattern.finditer(text):
            start, stop = m.start(), m.end()
            tok = by_content[m.group()]
            if tok.get("single_word", False):
                start_space = start == 0 or not _is_word_char(text[start - 1])
                stop_space = stop == len(text) or not _is_word_char(text[stop])
                if not (start_space and stop_space):
                    continue
            if tok.get("lstrip", False):
                new_start = start
                while new_start > 0 and text[new_start - 1] in _WS_CHARS:
                    new_start -= 1
                start = max(new_start, start_offset)
            if tok.get("rstrip", False):
                while stop < len(text) and text[stop] in _WS_CHARS:
                    stop += 1
            if start_offset < start:
                pieces.append((None, text[start_offset:start]))
            pieces.append((tok, None))
            start_offset = stop
        if start_offset < len(text):
            pieces.append((None, text[start_offset:]))
        return pieces

    def _bpe(self, word: str) -> list[int]:
        """One pre-tokenized piece (byte-level characters) -> ids: merges
        applied lowest rank first, then leftmost, as the ``tokenizers``
        package applies them."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = []
        for ch in word:
            i = self.vocab.get(ch)
            if i is None:
                if self.unk_token is None:
                    continue
                i = self.vocab.get(self.unk_token)
                if i is None:
                    raise ValueError(f"unknown token {self.unk_token!r} is not in the vocabulary")
            syms.append(i)
        n = len(syms)
        prev, nxt, alive = list(range(-1, n - 1)), list(range(1, n + 1)), [True] * n
        if n:
            nxt[-1] = -1
        heap = []
        for pos in range(n - 1):
            m = self.merges.get((syms[pos], syms[pos + 1]))
            if m is not None:
                heap.append((m[0], pos, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            syms[pos], alive[right] = new_id, False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] != -1:
                m = self.merges.get((syms[prev[pos]], syms[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = self.merges.get((syms[pos], syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        out = [s for s, keep in zip(syms, alive) if keep]
        self._cache[word] = out
        return out

    def _encode_plain(self, text: str) -> list[int]:
        """Text holding no raw-matched added token: NFC, the normalized added
        tokens, the split regex, the byte map, BPE."""
        ids: list[int] = []
        for tok, piece in self._split_added(unicodedata.normalize("NFC", text), self._norm_split):
            if tok is not None:
                ids.append(tok["id"])
                continue
            for word in split_pattern().findall(piece):
                ids.extend(self._bpe("".join(_BYTE_ENCODER[b] for b in word.encode("utf-8"))))
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok, piece in self._split_added(text, self._raw_split):
            if tok is not None:
                ids.append(tok["id"])
            elif piece:
                ids.extend(self._encode_plain(piece))
        return ids

    def encode_with_special(self, text: str) -> list[int]:
        return [self.bos_token_id, *self.encode(text), self.eos_token_id]

    def encode_chat(self, text: str, role: str) -> list[int]:
        return self.encode(f"<|im_start|>{role}\n{text}<|im_end|>")

    def encode_for_tts(self, text: str) -> list[int]:
        ids = self.encode_chat(text, "user")
        ids.extend(self.encode("<|im_start|>assistant\n"))
        return ids

    def encode_batch(self, texts: list[str]) -> list[list[int]]:
        return [self.encode(t) for t in texts]

    def encode_padded(self, text: str, max_length: int) -> list[int]:
        """Truncate or left-pad with the pad token."""
        ids = self.encode(text)
        if len(ids) > max_length:
            return ids[:max_length]
        return [self.pad_token_id] * (max_length - len(ids)) + ids

    def decode(self, ids: list[int]) -> str:
        """Ids -> text, special tokens skipped; ids outside the vocabulary are
        dropped, and byte sequences that are not UTF-8 become U+FFFD."""
        data = bytearray()
        for i in ids:
            i = int(i)
            if i in self._special_ids:
                continue
            token = self.id_to_token(i)
            if token is None:
                continue
            if all(c in _BYTE_DECODER for c in token):
                data.extend(_BYTE_DECODER[c] for c in token)
            else:
                data.extend(token.encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    def vocab_size(self) -> int:
        return len(self.vocab.keys() | self._added_by_content.keys())

    def token_to_id(self, token: str) -> int | None:
        added = self._added_by_content.get(token)
        return added["id"] if added is not None else self.vocab.get(token)

    def id_to_token(self, token_id: int) -> str | None:
        added = self._added_by_id.get(token_id)
        return added["content"] if added is not None else self._id_to_vocab.get(token_id)


def _special_tokens_from_config(vocab: dict[str, int], config: dict) -> list[dict]:
    """``added_tokens_decoder``'s special entries, in file order, each given
    its vocabulary id or the next id past the vocabulary and the tokens
    added so far (how the ``tokenizers`` package adds them)."""
    entries = config.get("added_tokens_decoder")
    if not isinstance(entries, dict):
        return []
    added: list[dict] = []
    for info in entries.values():
        content = info.get("content")
        if not content or not info.get("special", False):
            continue
        tok = {
            "content": content, "special": True, "lstrip": info.get("lstrip", False),
            "rstrip": info.get("rstrip", False), "normalized": info.get("normalized", False),
            "single_word": info.get("single_word", False),
        }
        if any(a["content"] == content for a in added):
            continue
        known = vocab.get(content)
        if known is None:
            top = max((a["id"] for a in added), default=None)
            known = len(vocab) if top is None or (top < len(vocab) and len(vocab) > 0) else top + 1
        added.append({"id": known, **tok})
    return added


def _check_qwen2(spec: dict, path) -> None:
    """Raise unless ``spec`` (a ``tokenizer.json``) is the Qwen2 pipeline."""

    def fail(what: str):
        raise ValueError(f"{path}: not the Qwen2 byte-level BPE pipeline ({what})")

    if (spec.get("normalizer") or {}).get("type") != "NFC":
        fail(f"normalizer {spec.get('normalizer')!r}")
    pre = spec.get("pre_tokenizer") or {}
    steps = pre.get("pretokenizers") if pre.get("type") == "Sequence" else None
    if not steps or len(steps) != 2:
        fail(f"pre_tokenizer {pre!r}")
    split, byte_level = steps
    if (split.get("type") != "Split" or (split.get("pattern") or {}).get("Regex") != PRETOKENIZE_REGEX
            or split.get("behavior") != "Isolated" or split.get("invert", False)):
        fail(f"split {split!r}")
    if byte_level.get("type") != "ByteLevel" or byte_level.get("add_prefix_space") or byte_level.get("use_regex"):
        fail(f"byte-level step {byte_level!r}")
    model = spec.get("model") or {}
    if (model.get("type") != "BPE" or model.get("dropout") is not None or model.get("byte_fallback", False)
            or model.get("ignore_merges", False) or model.get("fuse_unk", False)
            or model.get("continuing_subword_prefix") or model.get("end_of_word_suffix")):
        fail(f"model settings { {k: v for k, v in model.items() if k not in ('vocab', 'merges')}!r}")
    if (spec.get("decoder") or {}).get("type") != "ByteLevel":
        fail(f"decoder {spec.get('decoder')!r}")
