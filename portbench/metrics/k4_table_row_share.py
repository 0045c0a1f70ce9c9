"""K4's table-row share: the rows whose slot records each world's table
held, over all its rows, in %, over every K4 frame of the run (the
program's counters ``run_frame2.table_rows`` and ``run_frame2.rows``): 100
where every row keeps a record, less where only the rows that may hold a
slot do. None where K4 never ran or the program keeps no such counters."""


def read(ctx):
    from starframe_tpu_torch import hopper

    held = getattr(hopper.run_frame2, "table_rows", None)
    rows = getattr(hopper.run_frame2, "rows", 0)
    if held is None or not rows:
        return None
    return 100.0 * held / rows
