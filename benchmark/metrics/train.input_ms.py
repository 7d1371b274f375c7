"""Host wall ms per step of the program's span ``train_step/input``:
the uint8 batch copied to the card and normalized there."""


def read(view):
    spans = view.named("train_step/input", cats=("user_annotation",))
    if not spans or view.calls == 0:
        return None
    return sum(e["dur"] for e in spans) / 1e3 / view.calls
