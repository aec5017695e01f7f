"""The hand-written kernels' share of their roofline in the traced window:
the sum of each wrapper call's least time (`roofline.work`, from the work its
operands define) over the device time of the kernels those calls launched."""


def read(record):
    if not record["kernel_calls"] or record["kernel_device_s"] <= 0:
        return None
    return 100.0 * record["kernel_least_s"] / record["kernel_device_s"]
