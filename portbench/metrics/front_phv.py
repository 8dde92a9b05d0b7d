"""front_phv: the mean over the window's searches of the reference's
hypervolume of each returned front, each objective divided by the 3D
mesh's, against the reference point 1.6 (the port's PhvContext)."""


def read(run):
    return sum(run.verdict.phv) / len(run.verdict.phv)
