"""Seeded host-read violations in a kernel's launch wrapper (exact lines
asserted by tests/test_torch_analysis.py)."""


def launch(x, counts, c: int):
    if x.device.type == "cpu" and bool(((counts < 0) | (counts > c)).any()):
        raise ValueError("a count lies outside [0, C]")    # CPU: host data
    if bool((counts > c).any()):                # line 8: bool() on the card
        raise ValueError("a count lies outside [0, C]")
    if x.device.type == "cpu":
        return counts.tolist()                  # the CPU path: host data
    return x.sum().item()                       # line 12: .item()
