"""The reference ONet: the identity on RGB input. It has no leaves."""

# the input is the developed RGB already: nothing of the ISP's to judge
IDENTITY = True


def develop(x, leaves, **_):
    return x
