"""scan.finalize_s: host seconds of a sequence's last unit, ``finalize()``
then ``export()`` (the tail chunk of the frames after the last full
chunk, the drain, the refinement and the files; each ends in a pull),
the mean over the window's sequences.  Nothing where the entry has no
such unit."""


def read(run):
    xs = [u["seconds"] for u in run.units if u["kind"] == "finalize"]
    return sum(xs) / len(xs) if xs else None
