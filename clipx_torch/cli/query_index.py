"""``python -m clipx_torch.cli.query_index`` — the search REPL.

Counterpart of ``clipx/cli/query_index.py``: the same commands, prompt,
help text and output rows, with the port's encoder and index (on
``--device``, default cuda).

Reference behavior preserved (reference:query-index.py):
- prompt ``[h,q,i,r,a,c,p] >>> `` (:42) with commands
  ``q`` quit, ``h`` help (:45-47), ``p N`` probe count 1-100 (:48-54,
  now a no-op knob — search is exact), ``a`` toggle window align
  (:56-61), ``r WxH`` / ``r`` max resolution (:63-77), ``c N`` result
  count with reset-to-50 on N < 1 (:78-84), ``i ID`` image similarity
  (:86-99), empty line = next page (:100-103), anything else = text
  query (:104-108)
- ``i ID`` reuses the *stored* embedding from fn_db — no model forward
  (:94-95, SURVEY.md section 3.3)
- ``Search time: {:.4f}s`` per query (:110-113)
- result rows ``{score:.4f} {id} {path}`` (:119)
- the display loop skips ranks ``j <= offset`` — with offset 0 this
  drops rank 0 (:114-116). Deliberate for ``i ID`` (rank 0 is the query
  image itself), quirky for text queries (best hit hidden); preserved
  as part of the observable contract (SURVEY.md section 7)
- pagination state: ``offset = last_j`` and a re-search with
  ``k + offset + 1`` (:111); an empty line is ignored unless a text
  query happened earlier (``texts is None`` check, :101-103) — also
  preserved verbatim
- EOF / Ctrl-C prints ``Interrupted.`` (:155-158)

Deviation (documented): malformed integers after ``p ``/``c ``/``i ``
print an error instead of crashing the REPL (the reference's uncaught
``int()`` at :49,:79,:87).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from clipx_torch.cli import common
from clipx_torch.cli.viewer import ImageViewer
from clipx_torch.config import get_config
from clipx_torch.store.kv import open_env

HELP_TEXT = (
    "Enter a search query and you will receive a list of best matching\n"
    "images. The first number is the difference score, the second the\n"
    "image ID followed by the filename.\n\n"
    "Press q to stop viewing image and space for the next image.\n\n"
    "Just press enter for more results.\n\n"
    "Commands:\n"
    "q\tQuit\n"
    "i ID\tFind images similar to ID\n"
    "r [RES]\tSet maximum resolution (e.g. 1280x720)\n"
    "a\tToggle align window position\n"
    "c NUM\tSet default number of results to NUM\n"
    "p NUM\tSet number of subsets to probe (1-100, 32 default)\n"
    "h\tShow this help"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="query-index.py")
    common.add_model_flags(p)
    common.add_sharded_flag(p, "row-shard the corpus")
    return p


class QueryREPL:
    def __init__(self, args, *, input_fn: Callable[[str], str] = input,
                 viewer: Optional[ImageViewer] = None,
                 encoder=None):
        self.args = args
        self.input_fn = input_fn
        self.viewer = viewer if viewer is not None else ImageViewer()
        self.encoder = encoder  # lazy; tests can inject

        self.env = open_env(args.db, map_size=common.DEFAULT_MAP_SIZE,
                            max_dbs=4)
        self.idx_db = self.env.open_db(common.IDX_DB)
        self.fn_db = self.env.open_db(common.FN_DB)
        self.index = common.load_index(args)
        self.index.nprobe = 32  # reference:query-index.py:30

        self.k = 50              # reference:query-index.py:35
        self.offset = 0
        self.last_j = 0
        self.features: Optional[np.ndarray] = None
        self.texts = None        # set only by text queries (:104-108)
        self._warmup_async()     # reads self.k

    def _warmup_async(self) -> None:
        """Run one search off the critical path (placing the corpus and
        warming cuBLAS) so the first 'Search time:' measures search. (The
        encoder stays lazy — 'i ID' queries never need it.)"""
        self._warmup_thread = None
        if self.index.ntotal == 0 or os.environ.get("CLIPX_NO_WARMUP"):
            return
        import threading

        def work():
            # an error here prints its traceback and ends only this thread;
            # the first real search then raises it again
            self.index.search(np.zeros((1, self.index.dim), np.float32),
                              self.k + 1)

        self._warmup_thread = threading.Thread(target=work, daemon=True)
        self._warmup_thread.start()

    # -- encoder bootstrap is deferred: 'i ID' queries never need it ------
    def _get_encoder(self):
        if self.encoder is None:
            self.encoder = common.make_encoder(self.args)
        return self.encoder

    def run(self) -> int:
        try:
            while True:
                try:
                    in_text = self.input_fn("[h,q,i,r,a,c,p] >>> ").strip()
                except (EOFError, KeyboardInterrupt):
                    print("Interrupted.")
                    return 0
                if not self.handle(in_text):
                    return 0
        finally:
            # don't leave the warmup search racing process teardown
            if getattr(self, "_warmup_thread", None) is not None:
                self._warmup_thread.join(timeout=60)
            self.env.close()

    # returns False to quit
    def handle(self, in_text: str) -> bool:
        if in_text == "q":
            return False
        elif in_text == "h":
            print(HELP_TEXT)
        elif in_text.startswith("p "):
            self._cmd_probe(in_text[2:])
        elif in_text == "a":
            self.viewer.align_window = not self.viewer.align_window
            print("Aligning window position." if self.viewer.align_window
                  else "Not aligning window position.")
        elif in_text.startswith("r "):
            # note: bare "r" (no space) is a *text query* in the
            # reference (:63 only matches "r ") — kept that way
            self._cmd_resolution(in_text[2:])
        elif in_text.startswith("c "):
            self._cmd_count(in_text[2:])
        elif in_text.startswith("i "):
            if self._cmd_image_similarity(in_text[2:]):
                self._search_and_display()
        elif in_text == "":
            # pagination (:100-103): inert until a text query happened
            self.offset = self.last_j
            if self.texts is not None and self.features is not None:
                self._search_and_display()
        elif self._cmd_text_query(in_text):
            self._search_and_display()
        return True

    # -- commands ------------------------------------------------------------
    def _cmd_probe(self, arg: str) -> None:
        try:
            probe = int(arg)
        except ValueError:
            print("Invalid probe value.")
            return
        if 0 < probe < 101:
            # functional under --search-mode ivf (clipx/search/ivf.py);
            # the default exact engine ignores it
            self.index.nprobe = probe
            print(f"Set to probe {probe} subsets.")
            return
        print("Invalid probe value.")

    def _cmd_resolution(self, arg: str) -> None:
        try:
            x, y = arg.split("x")
            x, y = int(x), int(y)
            if x > 0 and y > 0:
                self.viewer.max_res = (x, y)
                print(f"Set maximum resolution to {x}x{y}.")
                return
        except Exception:
            pass
        self.viewer.max_res = None
        print("Unset maximum resolution.")

    def _cmd_count(self, arg: str) -> None:
        try:
            k = int(arg)
        except ValueError:
            print("Invalid result count.")
            return
        self.k = k
        if self.k < 1:
            self.k = 50
            print("Reset number of results to 50.")
            return
        print(f"Showing {self.k} results.")

    def _cmd_image_similarity(self, arg: str) -> bool:
        try:
            image_id = int(arg)
        except ValueError:
            print("Not found.")
            return False
        self.offset = 0
        self.last_j = 0
        try:
            key = f"{image_id}".encode()
            with self.env.begin(db=self.idx_db) as txn:
                key = txn.get(key)
            with self.env.begin(db=self.fn_db) as txn:
                raw = txn.get(key)
            self.features = np.frombuffer(raw, dtype=np.float32).reshape(1, -1)
            print(f"Similar to {key.decode()}:")
            return True
        except Exception:
            print("Not found.")
            return False

    def _cmd_text_query(self, in_text: str) -> bool:
        """Encode a text query; False, with a note, for a model whose
        tokenizer is not available (SigLIP's), whose index answers image
        ids only."""
        cfg = self.encoder.cfg if self.encoder else get_config(self.args.model)
        if cfg.tokenizer != "clip_bpe":
            print(f"Text queries need {cfg.name}'s {cfg.tokenizer} model, "
                  "which is not available; query by image id (i ID).")
            return False
        self.offset = 0
        self.last_j = 0
        self.texts = in_text
        self.features = self._get_encoder().encode_texts([in_text])
        return True

    # -- search + display (:110-154) -------------------------------------------
    def _search_and_display(self) -> None:
        search_start = time.perf_counter()
        D, I = self.index.search(self.features, self.k + self.offset + 1)
        search_time = time.perf_counter() - search_start
        print(f"Search time: {search_time:.4f}s")
        for j, i in enumerate(I[0]):
            if j <= self.offset:  # rank-0 skip quirk preserved (:114-116)
                continue
            if i < 0:
                break
            with self.env.begin(db=self.idx_db) as txn:
                raw = txn.get(f"{i}".encode())
            if raw is None:
                continue
            tfn = raw.decode()
            print(f"{D[0][j]:.4f} {i} {tfn}")
            self.last_j = j
            try:
                if self.viewer.show(tfn):
                    break
            except Exception:
                continue
        self.viewer.close()


def main(argv: List[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    common.check_device(args)
    if not os.path.exists(args.index):
        # a codes-only deployment boots from the codes file alone
        from clipx_torch.search import codes_io

        if not (codes_io.tier_of(args.corpus_dtype) is not None
                and os.path.exists(codes_io.codes_path(args.index))):
            print(f"No index found at {args.index!r} — run "
                  "build-index.py first.")
            return 1
    return QueryREPL(args).run()


if __name__ == "__main__":
    raise SystemExit(main())
