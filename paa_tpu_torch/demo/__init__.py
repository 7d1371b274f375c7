"""The demo of the port (port of demo/): ``COCODemo`` and its image and
webcam drivers."""
