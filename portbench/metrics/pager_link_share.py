"""Host-to-device bytes the weight pager moved in the window
(``PagerStats.bytes_loaded``) over the window's length times one
direction of the PCIe Gen5 x16 link."""


def read(w):
    moved = w.delta("pager_bytes_loaded")
    if moved is None or not w.gate_s:
        return None
    return 100.0 * moved / (w.gate_s * w.peaks["pcie_bytes_per_s"])
