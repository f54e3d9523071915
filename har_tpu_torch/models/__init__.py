"""Classifiers: histogram decision trees and random forests."""
