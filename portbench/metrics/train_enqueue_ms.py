"""Host milliseconds to enqueue one training step onto an empty queue: the
host clock from the start of a `train_steps(1)` call, made once the last
call's loss has been read, to its return, the median over the traced calls
(the training loop and the step's dispatch). Within a longer call the host
blocks once the launch queue is full, so there it reads the device's pace."""


def read(run):
    seconds = run.obs.get("train.enqueue_one_s")
    return None if not seconds else 1e3 * seconds
