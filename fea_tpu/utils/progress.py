"""Progress reporting: tqdm when it is installed, plain lines otherwise."""

import sys


class _Lines:
    """The slice of tqdm's interface the package uses, printed as a line
    at every tenth of the total (or every 100 items without a total)."""

    def __init__(self, iterable=None, total=None, initial=0, desc=""):
        self.iterable = iterable
        self.total = total if total is not None else _len(iterable)
        self.n = initial
        self.desc = desc
        self._printed = None

    def __iter__(self):
        for item in self.iterable:
            yield item
            self.update(1)

    def _mark(self):
        if self.total:
            return self.n * 10 // self.total
        return self.n // 100

    def update(self, n=1):
        self.n += n
        if self._mark() != self._printed:
            self._printed = self._mark()
            total = f"/{self.total}" if self.total else ""
            print(f"{self.desc}: {self.n}{total}", file=sys.stderr, flush=True)

    def set_description(self, desc):
        self.desc = desc

    def close(self):
        pass


def _len(iterable):
    try:
        return len(iterable)
    except TypeError:
        return None


def progress(iterable=None, *, total=None, initial=0, desc=""):
    try:
        from tqdm import tqdm
    except ImportError:
        return _Lines(iterable, total, initial, desc)
    return tqdm(iterable, total=total, initial=initial, desc=desc)
