"""An extension that records its calls, for the tests: each hook appends
to ``CALLS``, and ``judge`` returns the number the configuration's
``recording`` gives for the program or for the control."""
import numpy as np

CALLS = []


def prepare(config, traffic, world, truth, out_dir, ss):
    draw = int(ss.generate_state(1)[0])
    CALLS.append(("prepare", {"world_points": int(world.shape[0]), "truth": truth,
                              "out_dir": out_dir, "draw": draw}))
    return {"draw": draw}


def start(slam, seq, config, device):
    CALLS.append(("start", {"scans_taken": slam.scans_taken,
                            "pose": np.array(slam.mapper.map_to_range_sensor),
                            "extras": seq.extras}))


def judge(capture, seq, config, device, control):
    CALLS.append(("judge", control))
    return {"recorded_number": config["recording"]["control" if control else "program"]}
