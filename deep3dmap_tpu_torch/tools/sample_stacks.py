"""Run a script under a wall-clock stack sampler of its main thread.

    python3 -m deep3dmap_tpu_torch.tools.sample_stacks OUT.txt chip_smoke.py [args...]

Every 25 ms the main thread's stack is read; OUT.txt gets, by inclusive
seconds, the script's own lines (line and function of each of its frames),
the functions of every file, and the innermost functions (self seconds).
Written every 30 s and at exit.  A sample waits for the GIL, so a long C
call that holds it is counted late; child processes are not sampled (their
parent's wait on them is).  Imports no torch.
"""
import collections
import os
import runpy
import sys
import threading

DT = 0.025          # seconds between samples
DUMP_EVERY = 30.0   # seconds between writes of OUT.txt


class Sampler:
    def __init__(self, out: str, script: str):
        self.out, self.script = out, os.path.abspath(script)
        self.main_id = threading.get_ident()
        self.lines = collections.Counter()
        self.funcs = collections.Counter()
        self.leaf = collections.Counter()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def dump(self):
        with open(self.out, "w") as f:
            for title, counts, n in (("script lines (inclusive s)", self.lines, 400),
                                     ("functions (inclusive s)", self.funcs, 400),
                                     ("leaf functions (self s)", self.leaf, 150)):
                f.write(f"# {title}\n")
                for k, v in counts.most_common(n):
                    f.write(f"{v * DT:9.2f} {k}\n")

    def _sample(self):
        fr = sys._current_frames().get(self.main_id)
        seen_l, seen_f, first = set(), set(), True
        while fr is not None:
            co = fr.f_code
            key = f"{co.co_filename.split('site-packages/')[-1]}:{co.co_name}"
            if first:
                self.leaf[key] += 1
                first = False
            seen_f.add(key)
            if co.co_filename == self.script:
                seen_l.add(f"{fr.f_lineno} {co.co_name}")
            fr = fr.f_back
        self.funcs.update(seen_f)
        self.lines.update(seen_l)

    def _run(self):
        since = 0.0
        while not self.stop.wait(DT):
            self._sample()
            since += DT
            if since >= DUMP_EVERY:
                self.dump()
                since = 0.0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out, script = argv[0], argv[1]
    sys.argv = argv[1:]
    sampler = Sampler(out, script)
    sampler.thread.start()
    try:
        runpy.run_path(sampler.script, run_name="__main__")
    finally:
        sampler.stop.set()
        sampler.thread.join()
        sampler.dump()


if __name__ == "__main__":
    main()
