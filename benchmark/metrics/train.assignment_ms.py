"""Host wall ms per step of the program's span ``paa_loss/assignment``:
the IoU pre-assignment, the candidates and the GMM fit, its host reads
included."""


def read(view):
    spans = view.named("paa_loss/assignment", cats=("user_annotation",))
    if not spans or view.calls == 0:
        return None
    return sum(e["dur"] for e in spans) / 1e3 / view.calls
