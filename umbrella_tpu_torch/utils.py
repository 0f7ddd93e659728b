"""Console colorization, logging, and device resolution helpers."""
import contextlib
import logging

import torch

_COLORS = {
    "black": "\033[30m",
    "red": "\033[31m",
    "green": "\033[32m",
    "yellow": "\033[33m",
    "blue": "\033[34m",
    "magenta": "\033[35m",
    "cyan": "\033[36m",
    "white": "\033[37m",
    "reset": "\033[0m",
}


class TextColors:
    COLORS = _COLORS

    @staticmethod
    def colorize(text: str, color: str) -> str:
        code = _COLORS.get(color.lower(), _COLORS["reset"])
        return f"{code}{text}{_COLORS['reset']}"


def setup_logger(name: str = "umbrella_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setLevel(level)
        handler.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        )
        logger.addHandler(handler)
    return logger


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The GPU is the default; a CUDA device
    that does not exist raises instead of carrying on quietly on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass device='cpu' "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_scope(device):
    """`device` as the calling thread's current CUDA device, for code that
    reads the current device (graph captures, streams, events): a thread
    starts on cuda:0 whatever device its engine is on. Nothing on the CPU
    or for None."""
    if device is None or torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(torch.device(device))
