"""K4's live joint-slot share: the joint slot items that hold a joint row
(each body's joints, up to ``joint_slot_capacity``), which K4's joint
branch walks beside the empty ones, over all ``W x JC x N`` items, in %,
over every joint-slot build of the traced episodes (the program's
counters ``build_joint_slots.live_slots``, a device tensor, and
``build_joint_slots.slot_items``, kept only while a profiler records).
None where no jointed batch was traced or the program keeps no such
counters."""


def read(ctx):
    from starframe_tpu_torch import hopper

    live = getattr(hopper.build_joint_slots, "live_slots", None)
    items = getattr(hopper.build_joint_slots, "slot_items", 0)
    if live is None or not items:
        return None
    return 100.0 * int(live.sum()) / items
