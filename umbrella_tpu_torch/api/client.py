"""Socket API client, the counterpart of `umbrella_tpu/api/client.py`."""
from __future__ import annotations

import socket
import time

from ..utils import TextColors, setup_logger
from .api_utils import receive_data, send_data

logger = setup_logger()


class APIClient:
    def __init__(self, port: int, host: str = "127.0.0.1", retry_seconds: float = 5.0):
        self.port = port
        self.host = host
        self.retry_seconds = retry_seconds

    def run(self):
        """Connect (retrying while the server is not up yet) and return the
        server's welcome message."""
        self.client_socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        while True:
            try:
                self.client_socket.connect((self.host, self.port))
                break
            except ConnectionRefusedError:
                logger.info(TextColors.colorize("Server is not available, retrying...", "red"))
                time.sleep(self.retry_seconds)
        confirmation = receive_data(self.client_socket)
        logger.info(TextColors.colorize(f"Server confirmation: {confirmation}", "cyan"))
        return confirmation

    def get_output(self, **api_args) -> dict:
        send_data(self.client_socket, api_args)
        return receive_data(self.client_socket)

    def stream_output(self, **api_args):
        """Generator of partial frames {"partial": true, "generated_text": ...}
        ending with the final result dict ({"processed": true}). Only for a
        connection with no other request in flight (pipelined streams pair
        frames with requests by req_id)."""
        send_data(self.client_socket, dict(api_args, stream=True))
        while True:
            frame = receive_data(self.client_socket)
            yield frame
            if not frame.get("partial", False):
                return

    def close(self):
        send_data(self.client_socket, {"terminate": True})
        self.client_socket.close()
