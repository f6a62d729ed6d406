"""The driver-side fencing manifest."""

EPOCH_CMDS = ("submit", "drain")


def send(cmd, epoch):
    return [{"cmd": "submit", "epoch": epoch},
            {"cmd": "drain", "epoch": epoch}][cmd]
