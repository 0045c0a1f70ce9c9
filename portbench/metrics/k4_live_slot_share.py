"""K4's live share: the (row, solve slot) items whose manifold has an
active point, which K4's slot phases walk, over all its items, in %, over
every K4 frame of the run (the program's counters ``run_frame2.
live_items``, a device tensor, and ``run_frame2.slot_items``). None where
K4 never ran or the program keeps no such counters."""


def read(ctx):
    from starframe_tpu_torch import hopper

    live = getattr(hopper.run_frame2, "live_items", None)
    slots = getattr(hopper.run_frame2, "slot_items", 0)
    if live is None or not slots:
        return None
    return 100.0 * int(live.sum()) / slots
