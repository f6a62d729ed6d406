"""Good twin: the worker's mirrors of the roles and the
fenced commands, each paired with its authority by path."""

ROLES = ("prefill", "decode", "unified")
FENCED_CMDS = ("submit", "drain")


def dispatch(cmd):
    if cmd == "submit":
        return 1
    if cmd == "drain":
        return 2
    return 0
