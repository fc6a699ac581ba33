"""Optical music recognition: segmentation U-Nets on a torch device and
the geometric detectors on the host (numpy and scipy, no OpenCV)."""
