#!/bin/bash
# Build the port's GPU image (container-gpu/Dockerfile) and push it to
# ECR, creating the repository if it is missing.  Prints the image URI to
# pass as maskrcnn.image / serve.image / autoscaler.image to the GPU
# charts.
#
# Usage: [REGION=us-west-2] [IMAGE_NAME=eksml-gpu] [IMAGE_TAG=latest] \
#        bash container-gpu/build_tools/build_and_push.sh
#
# Needs docker, the AWS CLI with credentials, and network access (the
# CUDA base image, the PyTorch wheels and PyPI).

set -euo pipefail
cd "$(dirname "$0")"
REPO_ROOT="$(cd ../.. && pwd)"

REGION=${REGION:-us-west-2}
IMAGE_NAME=${IMAGE_NAME:-eksml-gpu}
IMAGE_TAG=${IMAGE_TAG:-latest}
ACCOUNT=${ACCOUNT:-$(aws sts get-caller-identity --query Account --output text)}
REGISTRY="${ACCOUNT}.dkr.ecr.${REGION}.amazonaws.com"
IMAGE="${REGISTRY}/${IMAGE_NAME}:${IMAGE_TAG}"

aws ecr describe-repositories --region "$REGION" \
    --repository-names "$IMAGE_NAME" >/dev/null 2>&1 || \
  aws ecr create-repository --region "$REGION" \
    --repository-name "$IMAGE_NAME" >/dev/null
aws ecr get-login-password --region "$REGION" | \
  docker login --username AWS --password-stdin "$REGISTRY"

docker build -t "$IMAGE" -f "$REPO_ROOT/container-gpu/Dockerfile" \
  "$REPO_ROOT"
docker push "$IMAGE"
echo "$IMAGE"
